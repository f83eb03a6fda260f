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
`decode_segment` runs its steps with no read of the device at all. Its
steps take their cache slots from a device index, so on a CUDA device the
whole segment is ONE CUDA graph launch (`runtime/graph.py`): the first
call of a key (config, sampling, params, generator, batch, cache shape,
n_steps) runs the segment eagerly and captures it (`_StreamGraph`), and
every later segment of every stream of that key replays it. An int4 cache
keeps the host-index loop.

Spans (`neutts_tpu_torch.utils`): each eager step is a `decode.step`; a
replay and a capture are spans of `runtime/graph.py`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from neutts_tpu_torch.config import BackboneConfig, SamplingConfig, resolve_kv_dtype, round_up
from neutts_tpu_torch.models import backbone as bb
from neutts_tpu_torch.ops import attention as attn_ops
from neutts_tpu_torch.ops import sampling as smp
from neutts_tpu_torch.parallel import tensor as tp_ops
from neutts_tpu_torch.runtime import graph
from neutts_tpu_torch.utils import span

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
             generator: Optional[torch.Generator] = None, tp=None) -> GenerateResult:
    """Prefill + AR decode over left-padded prompts [B, Lp] (int32, true
    lengths prompt_lens [B]). Sampling draws from `generator`.

    Tensor parallelism: `tp` is the Mesh of a rank holding
    `parallel.mesh.shard_params`' slices and its data rank's rows; its cache
    keeps the KV heads its query heads read. Every rank of a model-axis
    group computes the same logits, so greedy decoding gives every rank the
    same tokens; to sample, seed the ranks' `generator`s of one group alike,
    and they draw the same tokens too."""
    B, Lp = tokens.shape
    dev = tokens.device
    cap = max(min(max_new, cfg.max_context - 1), 1)
    cfg = resolve_cfg(cfg, Lp, cap)
    pad = (Lp - prompt_lens).to(torch.int32)
    cache = bb.KVCache.create(cfg, B, max_len=round_up(Lp + cap, _cache_align(cfg)), device=dev,
                              kv_heads=tp_ops.n_kv_heads(cfg, tp))

    t0 = time.perf_counter()
    logits, cache = bb.prefill(cfg, params, tokens, prompt_lens, cache, tp=tp)

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
                                       trim_logits=False, tp=tp)
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
    loop); a segment fills them into its device index (`_fill_index`)."""

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
    physical cache emit EOS. The caller checks `state.done` / `lengths`.

    A bf16, f32 or int8 cache takes the steps' cache slots from a device
    index (`_segment_body`), and on a CUDA device replays one captured
    graph of the whole segment (`_StreamGraph`); an int4 cache, whose token
    write pairs nibbles by the slot's parity, runs the host-index loop
    (`_segment_host`). The returned tensors are new on every call."""
    if state.cache.int4:
        return _segment_host(cfg, sampling, eos_id, n_steps, params, state)
    if state.token.is_cuda and _graphs_supported(sampling, state):
        return _segment_graphed(cfg, sampling, eos_id, n_steps, params, state)
    index = _fill_index(torch.empty(2, dtype=torch.int32, device=state.token.device), state)
    out, token, done, lengths = _segment_body(cfg, sampling, eos_id, n_steps, params, state,
                                              index, traced=True)
    return _advanced(state, n_steps, token, done, lengths), out


def _advanced(state: DecodeState, n_steps: int, token, done, lengths) -> DecodeState:
    return dataclasses.replace(state, token=token, done=done, lengths=lengths,
                               step=state.step + n_steps)


def _fill_index(index: torch.Tensor, state: DecodeState) -> torch.Tensor:
    """index [2] int32 <- (the cache slot of the token the segment's first
    step feeds, the tokens generated before it), filled on the device: a
    host-to-device copy would wait for the stream."""
    index[0].fill_(state.prompt_end + state.step - 1)
    index[1].fill_(state.step)
    return index


def _write_token_kv(cache: bb.KVCache, l: int, slot: torch.Tensor, kf: torch.Tensor,
                    vf: torch.Tensor) -> None:
    """`bb.write_kv` of one token per row [B, KD] at a shared slot given as a
    device index [1] (a float or int8 cache)."""
    if cache.quantized:
        for buf, scales, x in ((cache.k, cache.k_scale, kf), (cache.v, cache.v_scale, vf)):
            q, sc = bb.quantize_kv(x)
            buf[l].index_copy_(1, slot, q[:, None])
            scales[l].index_copy_(1, slot, sc[:, None])
    else:
        cache.k[l].index_copy_(1, slot, kf[:, None].to(cache.k.dtype))
        cache.v[l].index_copy_(1, slot, vf[:, None].to(cache.v.dtype))


def _segment_body(cfg, sampling, eos_id, n_steps, params, state: DecodeState,
                  index: torch.Tensor, traced: bool):
    """n_steps steps over `state` (a float or int8 cache) with every cache
    slot read from `index` (`_fill_index`) on the device, so that the host
    computes nothing that changes from one segment to the next. Writes the
    cache alone; returns (tokens [B, n_steps], token, done, lengths), all
    new tensors. Step i feeds its token at slot index[0] + i: a slot past
    the physical cache is clamped to its last (JAX clamps the write), and
    then every row already emits EOS. `traced`: each step is a
    `decode.step` span."""
    cache, pad = state.cache, state.pad
    B, T = state.token.shape[0], cache.max_len
    ar = torch.arange(n_steps, dtype=torch.int32, device=state.token.device)
    slot = index[0] + ar  # [S] the slot of each step's fed token
    at = torch.clamp(slot, max=T - 1)
    cols = at.long()
    lens = (at + 1)[:, None].expand(n_steps, B).contiguous()  # attend [pad, slot]
    positions = at[:, None] - pad[None, :]  # RoPE: the real tokens before it
    # past the real-length cap per row, or the physical one: the token
    # emitted at step i is fed next at slot + 1
    nxt_slot = slot[:, None] + 1
    capped = ((nxt_slot - pad[None, :]) >= cfg.max_context) | (nxt_slot >= T)
    suppress = (index[1] + ar) < sampling.min_new_tokens  # [S]
    layers = [bb.layer_params(params, l) for l in range(cfg.n_layers)]
    out = torch.empty((B, n_steps), dtype=torch.int32, device=state.token.device)
    token, done, lengths = state.token, state.done, state.lengths
    for i in range(n_steps):
        def attend(l, q, k, v, i=i):
            _write_token_kv(cache, l, cols[i : i + 1], k, v)
            return attn_ops.decode_attention(q, cache.k, cache.v, l, lens[i], pad,
                                             cache.k_scale, cache.v_scale)

        with span("decode.step") if traced else contextlib.nullcontext():
            h = bb.decode_hidden(cfg, params, layers, token, positions[i], attend)
            nxt = smp.sample_from_hidden(cfg, sampling, params, h, state.generator, eos_id,
                                         suppress[i])
            nxt = torch.where(done | capped[i], eos_id, nxt).to(torch.int32)
            out[:, i] = nxt
            lengths = lengths + (~done).to(torch.int32)
            done = done | (nxt == eos_id)
            token = nxt
    return out, token, done, lengths


def _segment_host(cfg, sampling, eos_id, n_steps, params, state: DecodeState):
    """`decode_segment` with each step's cache slot a host index, step by
    step (`bb.decode_step`): the int4 cache's path, and the oracle of the
    device-index body."""
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
        with span("decode.step"):
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
    return _advanced(state, n_steps, token, done, lengths), out


# --- the segment as one CUDA graph -----------------------------------------------------

_STREAM_INPUTS = ("token", "done", "lengths", "pad")
_GRAPHS_KEPT = 8  # captured segments kept per device; the least recently used goes first
_stream_graphs: Dict[int, Dict[tuple, "_StreamGraph"]] = {}  # device index -> key -> graph


def _cache_tensors(cache: bb.KVCache) -> list:
    return [getattr(cache, f.name) for f in dataclasses.fields(cache)
            if getattr(cache, f.name) is not None]


def _graphs_supported(sampling: SamplingConfig, state: DecodeState) -> bool:
    """`graph.supported`; sampling from the default generator (no
    `state.generator`) stays eager."""
    return graph.supported(sampling) and (sampling.greedy or state.generator is not None)


class _StreamGraph(graph.SegmentGraph):
    """One segment of `_segment_body` over static buffers of its own (a
    cache of the streams' shape, token, done, lengths, pad and the index),
    replayable as one CUDA graph, and shared by every stream of its key.

    `run` copies a state's cache and tensors into the buffers and fills the
    index, runs the segment, copies the cache back into the state's own and
    returns clones of the rest: of the state's tensors only its cache is
    written, and streams of one key may take turns segment by segment. The
    body bakes in the config, the sampling config, eos_id, n_steps, the
    params and the generator."""

    outputs = ("token", "done", "lengths")

    def __init__(self, cfg, sampling, eos_id, n_steps, params, state: DecodeState):
        super().__init__(cfg, sampling, eos_id, n_steps, params, steps=n_steps)
        self.static = dataclasses.replace(
            state, cache=bb.KVCache(*(torch.empty_like(t) for t in _cache_tensors(state.cache))),
            **{n: torch.empty_like(getattr(state, n)) for n in _STREAM_INPUTS})
        self.index = torch.zeros(2, dtype=torch.int32, device=state.token.device)

    def body(self, traced: bool = False):
        """The segment over the static buffers (the captured body)."""
        return _segment_body(*self.args, self.static, self.index, traced)

    def run(self, state: DecodeState, segment) -> Tuple[DecodeState, torch.Tensor]:
        ours, theirs = _cache_tensors(self.static.cache), _cache_tensors(state.cache)
        for mine, t in zip(ours, theirs):
            mine.copy_(t)
        for n in _STREAM_INPUTS:
            getattr(self.static, n).copy_(getattr(state, n))
        _fill_index(self.index, state)
        out, token, done, lengths = segment()
        for mine, t in zip(ours, theirs):
            t.copy_(mine)
        return (_advanced(state, self.args[3], token.clone(), done.clone(), lengths.clone()),
                out.clone())


def _segment_graphed(cfg, sampling, eos_id, n_steps, params, state: DecodeState):
    """A segment on a CUDA device: the replay of its key's graph, captured on
    the key's first call. The key holds what the body bakes in and the
    buffers' shapes, not the stream's cache, so every later stream replays
    the same graph. A graph keeps its params and generator alive, so their
    ids in the key name them alone."""
    cache = state.cache
    key = (cfg, sampling, eos_id, n_steps, id(params), id(state.generator),
           state.token.shape[0], cache.max_len, cache.k.dtype,
           smp.use_speech_head(cfg, sampling, params))
    store = _stream_graphs.setdefault(state.token.device.index, {})
    seg = store.pop(key, None)
    if seg is None:
        seg = _StreamGraph(cfg, sampling, eos_id, n_steps, params, state)
        state, out = seg.capture(state)
    else:
        state, out = seg.replay(state)
    store[key] = seg  # the most recently used last
    while len(store) > _GRAPHS_KEPT:
        del store[next(iter(store))]
    return state, out
