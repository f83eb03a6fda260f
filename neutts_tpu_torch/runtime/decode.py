"""Autoregressive decode: prefill, then a host loop of decode steps (port of
`neutts_tpu.runtime.decode`, the `generate` path).

Semantics kept from the JAX package:
  * prompts are LEFT-padded to a bucket, so every row's next token lands at
    one shared cache slot;
  * the KV cache is preallocated at round_up(Lp + cap, _cache_align(cfg));
  * per-row real-length caps: a row stops once prompt length + generated
    reaches max_context (left pad does not count), and finished rows keep
    emitting EOS without growing their length;
  * the loop ends when every row is done or `cap` steps have run.

The JAX loop is one jitted `lax.while_loop`; here it is a Python loop that
reads one flag from the device per step to stop early.
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional, Tuple

import torch

from neutts_tpu_torch.config import BackboneConfig, SamplingConfig, resolve_kv_dtype, round_up
from neutts_tpu_torch.models import backbone as bb
from neutts_tpu_torch.ops import sampling as smp

# Dense 64-step prompt buckets, as in the JAX package.
PROMPT_BUCKETS = tuple(range(128, 2048 + 1, 64))


def _cache_align(cfg: BackboneConfig) -> int:
    """Physical cache lengths are multiples of this — the JAX package's
    alignment, 256 for bf16/int8 and 512 for int4 — so the two packages'
    caches have one shape."""
    return 512 if cfg.kv_dtype == "int4" else 256


class GenerateResult(NamedTuple):
    tokens: torch.Tensor  # [B, max_new] int32, EOS-filled
    lengths: torch.Tensor  # [B] int32 valid tokens per row (incl. EOS)
    steps: int  # loop iterations executed (incl. the prefill's token)
    prefill_s: float = 0.0  # wall seconds of the prefill (device-synchronised)
    decode_s: float = 0.0  # wall seconds of the decode loop


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def resolve_cfg(cfg: BackboneConfig, Lp: int, cap: int) -> BackboneConfig:
    """kv_dtype resolution as in the JAX `generate`: "auto" by the call's
    total context Lp + cap. int4 packs token pairs and needs an even prompt
    bucket; an odd one (only reachable at the max_context - 1 window edge)
    falls back to int8."""
    cfg = resolve_kv_dtype(cfg, Lp + cap)
    if cfg.kv_dtype == "int4" and Lp % 2:
        cfg = cfg.scaled(kv_dtype="int8")
    return cfg


@torch.inference_mode()
def generate(cfg: BackboneConfig, sampling: SamplingConfig, eos_id: int, max_new: int,
             params, tokens: torch.Tensor, prompt_lens: torch.Tensor,
             generator: Optional[torch.Generator] = None) -> GenerateResult:
    """Prefill + AR decode over left-padded prompts [B, Lp] (int32, true
    lengths prompt_lens [B]). Sampling draws from `generator`."""
    B, Lp = tokens.shape
    dev = tokens.device
    cap = max(min(max_new, cfg.max_context - 1), 1)
    cfg = resolve_cfg(cfg, Lp, cap)
    pad = (Lp - prompt_lens).to(torch.int32)
    cache = bb.KVCache.create(cfg, B, max_len=round_up(Lp + cap, _cache_align(cfg)), device=dev)

    t0 = time.perf_counter()
    logits, cache = bb.prefill(cfg, params, tokens, prompt_lens, cache)

    def sample(logits, step):
        return smp.sample_step(logits, generator, sampling, eos_id,
                               step < sampling.min_new_tokens, vocab_size=cfg.vocab_size)

    first = sample(logits, 0)
    _sync(dev)
    t1 = time.perf_counter()
    out = torch.full((B, max_new), eos_id, dtype=torch.int32, device=dev)
    out[:, 0] = first
    done = first == eos_id
    lengths = torch.ones(B, dtype=torch.int32, device=dev)
    token = first
    step = 1
    while step < cap and not bool(done.all()):
        cur_index = Lp + step - 1  # cache slot of the token fed in
        logits, cache = bb.decode_step(cfg, params, token, cache, cur_index, pad,
                                       trim_logits=False)
        nxt = sample(logits, step)
        in_ctx = (prompt_lens + step) < cfg.max_context
        nxt = torch.where(done | ~in_ctx, eos_id, nxt).to(torch.int32)
        out[:, step] = nxt
        lengths += (~done).to(torch.int32)
        done = done | (nxt == eos_id)
        token = nxt
        step += 1
    _sync(dev)
    t2 = time.perf_counter()
    return GenerateResult(tokens=out, lengths=lengths, steps=step,
                          prefill_s=t1 - t0, decode_s=t2 - t1)


# --- host-side helpers ----------------------------------------------------------


def bucket_length(n: int, buckets=PROMPT_BUCKETS) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"prompt length {n} exceeds max bucket {buckets[-1]}")


def pad_prompts(prompts, pad_id: int, bucket: Optional[int] = None,
                device="cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """LEFT-pad id lists to a shared bucketed length -> (tokens [B, L] int32,
    lengths [B] int32) on `device`."""
    lens = [len(p) for p in prompts]
    L = bucket or bucket_length(max(lens))
    if max(lens) > L:
        raise ValueError(f"prompt of length {max(lens)} does not fit bucket {L}")
    arr = [[pad_id] * (L - len(p)) + list(p) for p in prompts]
    return (torch.tensor(arr, dtype=torch.int32, device=device),
            torch.tensor(lens, dtype=torch.int32, device=device))


def extract(result: GenerateResult, row: int, eos_id: int) -> list:
    """Row `row`'s valid continuation, without the closing EOS."""
    n = int(result.lengths[row])
    toks = [int(t) for t in result.tokens[row, :n].tolist()]
    if toks and toks[-1] == eos_id:
        toks = toks[:-1]
    return toks
