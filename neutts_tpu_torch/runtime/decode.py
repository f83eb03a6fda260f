"""Autoregressive decode: prefill, then a host loop of decode steps (port of
`neutts_tpu.runtime.decode`): `generate` for the batch path, and the
segmented decode of streaming (`prefill_init`, then `decode_segment` once
per chunk, the state kept on the device between segments).

Semantics kept from the JAX package:
  * prompts are LEFT-padded to a bucket, so every row's next token lands at
    one shared cache slot;
  * the KV cache is preallocated at round_up(Lp + cap, _cache_align(cfg));
  * per-row real-length caps: a row stops once prompt length + generated
    reaches max_context (left pad does not count), and finished rows keep
    emitting EOS without growing their length;
  * the loop ends when every row is done or `cap` steps have run.

The JAX loop is one jitted `lax.while_loop`; here `generate` is a Python
loop that reads one flag from the device per step to stop early, and
`decode_segment` runs its steps with no read of the device at all.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
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


# --- segmented decode (streaming) ------------------------------------------------
#
# Streaming prefills once, then runs one `decode_segment` per chunk of
# tokens. Everything the loop carries stays on the device between segments;
# the caller reads `done` once per segment, as the JAX pipeline does.


@dataclass
class DecodeState:
    """What a segmented decode carries between segments. The tensors live on
    the device. `step` and `prompt_end` are host integers: the step count
    advances by one per step whatever the device computes, so the host knows
    it without a read (JAX carries both as device scalars inside its jitted
    loop), and the cache slot of each step is a host index, as in
    `generate`."""

    cache: bb.KVCache
    token: torch.Tensor  # [B] int32, last emitted token
    done: torch.Tensor  # [B] bool
    lengths: torch.Tensor  # [B] int32, tokens generated so far (incl. EOS)
    pad: torch.Tensor  # [B] int32 left-pad amounts
    step: int  # tokens generated so far
    prompt_end: int  # Lp
    generator: Optional[torch.Generator] = None  # the sampling stream


@torch.inference_mode()
def prefill_init(cfg: BackboneConfig, sampling: SamplingConfig, eos_id: int, params,
                 tokens: torch.Tensor, prompt_lens: torch.Tensor,
                 generator: Optional[torch.Generator] = None
                 ) -> Tuple[DecodeState, torch.Tensor]:
    """Prefill over left-padded prompts [B, Lp] into a cache of
    round_up(max_context, align) slots, and sample the first token (through
    the speech head when sampling is constrained to it and it is attached).
    Returns (state, first token [B] int32)."""
    B, Lp = tokens.shape
    dev = tokens.device
    # a stream is open-ended: "auto" resolves against the whole window
    cfg = resolve_cfg(cfg, Lp, cfg.max_context - Lp)
    pad = (Lp - prompt_lens).to(torch.int32)
    cache = bb.KVCache.create(cfg, B, max_len=round_up(cfg.max_context, _cache_align(cfg)),
                              device=dev)
    speech = smp.use_speech_head(cfg, sampling, params)
    logits, cache = bb.prefill(cfg, params, tokens, prompt_lens, cache, speech_head=speech)
    first = smp.sample_logits(logits, generator, cfg, sampling, eos_id,
                              0 < sampling.min_new_tokens, speech=speech)
    state = DecodeState(cache=cache, token=first, done=first == eos_id,
                        lengths=torch.ones(B, dtype=torch.int32, device=dev), pad=pad,
                        step=1, prompt_end=Lp, generator=generator)
    return state, first


@torch.inference_mode()
def decode_segment(cfg: BackboneConfig, sampling: SamplingConfig, eos_id: int, n_steps: int,
                   params, state: DecodeState) -> Tuple[DecodeState, torch.Tensor]:
    """Up to n_steps more tokens -> (state, tokens [B, n_steps] int32), the
    cache updated in place. No step reads the device: rows that finish keep
    emitting EOS without growing their length, and steps past a row's
    real-length cap (max_context, left pad not counted) or past the
    physical cache emit EOS. The caller checks `state.done` / `lengths`."""
    B = state.token.shape[0]
    dev = state.token.device
    out = torch.full((B, n_steps), eos_id, dtype=torch.int32, device=dev)
    speech = smp.use_speech_head(cfg, sampling, params)
    T_phys = state.cache.max_len
    token, done, lengths = state.token, state.done, state.lengths
    Lp = state.prompt_end
    for i in range(n_steps):
        step = state.step + i  # tokens generated before this one
        cur_index = Lp + step - 1  # cache slot of the token fed in
        if cur_index >= T_phys:
            # the step before had no slot left for its token and emitted EOS
            # on every row: nothing is left to compute (JAX clamps the write)
            token = torch.full_like(token, eos_id)
            continue
        # real-length cap per row, and the physical one: the token emitted
        # now is fed next step at slot Lp + step
        in_ctx = (Lp - state.pad + step) < cfg.max_context
        if Lp + step >= T_phys:
            in_ctx = torch.zeros_like(in_ctx)
        logits, _ = bb.decode_step(cfg, params, token, state.cache, cur_index, state.pad,
                                   trim_logits=False, speech_head=speech)
        nxt = smp.sample_logits(logits, state.generator, cfg, sampling, eos_id,
                                step < sampling.min_new_tokens, speech=speech)
        nxt = torch.where(done | ~in_ctx, eos_id, nxt).to(torch.int32)
        out[:, i] = nxt
        lengths = lengths + (~done).to(torch.int32)
        done = done | (nxt == eos_id)
        token = nxt
    state = DecodeState(cache=state.cache, token=token, done=done, lengths=lengths,
                        pad=state.pad, step=state.step + n_steps, prompt_end=Lp,
                        generator=state.generator)
    return state, out
