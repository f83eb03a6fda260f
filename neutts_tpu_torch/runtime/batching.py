"""Continuous-batching decode core: per-slot cache state and the segment
steps of the serving engine (port of `neutts_tpu.runtime.batching`).

A fixed pool of B slots, each an independent sequence with its own cached
length, left pad and phase (empty / active / done):

  * `prefill_slots` admits a group of LEFT-padded prompts (one bucket Lp)
    into slots, so each admitted row's settled length is Lp;
  * `decode_steps` advances every active slot n_steps tokens. With an int8
    or int4 cache it runs SEGMENT-STAGED on every device: each step's
    quantized K/V goes to a staging buffer at the segment column i (shared
    by all rows; unpacked int4 values for an int4 cache),
    `decode_attention_staged` attends settled cache [pad, base) + staging
    [0, i], and one `reconcile_segment` (int4: `reconcile_segment4`, which
    packs the pairs) folds the staging into each row's cache slots
    [base, base + S) at segment end. Float caches take the direct per-row
    write path (`_decode_steps_scatter`), which stays callable for int8 and
    int4 as the staged path's oracle. The JAX package picks the staged path
    only on a TPU; here the CPU runs the same code with the kernels' plain
    versions;
  * `retire_slots` deactivates slots between segments.

int4 alignment: admission buckets are multiples of 64 and int4 segments of
SEGMENT_ALIGN_INT4 steps, so every segment base is even and every byte the
reconcile writes holds a complete token pair; an odd admission bucket
raises.

State lives on the device between calls. The KV cache is updated in place;
the small per-slot tensors (token, lens, pad, prompt_lens, active) are
replaced by new tensors, never written in place, so a tensor read from the
state stays valid after the next call. Nothing here reads a value back to
the host: a whole segment is queued without a synchronisation.

On a CUDA device a staged segment is ONE CUDA graph launch
(`runtime/graph.py`): the first call for a state and step count runs the
segment eagerly, then captures it (`_SegmentGraph`: static per-slot
buffers, copied in before each replay and cloned out after it); every
later call replays the graph. The segment's host ints (the staging
column, the layer, n_steps, the cache length) are the same in every
segment. An admission is one graph launch too (`_AdmitGraph`), one graph
per state and shape (G rows, bucket Lp) over static inputs, all of a
state's admission graphs in one memory pool.

The model family is one block interface, picked once per config
(`block`): `models/qwen2.py` (the Qwen2 block of `models/backbone.py`),
`models/lfm2.py` and `models/moonlight.py` each give `prepare_params`,
`layer_params`, `state_shapes` (device state beside the cache, made by
`SlotState.create`), `prefill_hidden` and `decode_hidden`, called alike.
  * An LFM2-MoE config (`config.Lfm2Config`) keeps two kinds of state side
    by side: the KV cache of its attention layers alone (the model's
    attention index is the cache layer) and each conv layer's state
    (`SlotState.conv`), which admission writes, every step reads and
    replaces in place, and retirement zeroes.
  * A Moonlight config (`config.MoonlightConfig`) keeps a latent cache: one
    int8 buffer of 576-value rows with a scale a token, no V buffer
    (`backbone.KVCache` latent mode). Its staging, reconcile and admission
    write move that one buffer, and its staged attention is the MLA kernel
    (`ops/attention.mla_decode_staged`).
  * Both route every row's token over their experts on the device;
    `SlotState.expert_rows` counts the rows each expert took in each MoE
    layer and the steps in which it took any, in place, inside the
    captured segment too.

Spans (`neutts_tpu_torch.utils`): each eager step is a `decode.step`; a
replay and a capture, of a segment or an admission, are spans of
`runtime/graph.py`.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Optional, Tuple

import torch

from neutts_tpu_torch.config import (BackboneConfig, Lfm2Config, MoonlightConfig, SamplingConfig,
                                     round_up)
from neutts_tpu_torch.models import backbone as bb
from neutts_tpu_torch.models import lfm2, moonlight, qwen2
from neutts_tpu_torch.ops import attention as attn_ops
from neutts_tpu_torch.ops import sampling as smp
from neutts_tpu_torch.runtime import graph
from neutts_tpu_torch.runtime.decode import PROMPT_BUCKETS
from neutts_tpu_torch.utils import span

SEGMENT_ALIGN = 8  # segment step counts must be multiples of this
SEGMENT_ALIGN_INT4 = 16  # ... and of this with an int4 cache (even bases)
BLOCK_T = 256  # physical slot lengths are multiples of this (the JAX package's)

# Extra physical cache slots per row beyond max_context: the worst left pad
# of a bucketed admission plus a full segment (<= SEG_PAD steps) of reconcile
# headroom, so the physical bound in `_in_ctx` never binds before the
# real-length cap (max_context including the prompt).
_MAX_BUCKET_GAP = max(b - a for a, b in zip((0,) + PROMPT_BUCKETS[:-1], PROMPT_BUCKETS))
CACHE_SLACK = round_up(_MAX_BUCKET_GAP - 1 + attn_ops.SEG_PAD, 128)  # 256


# the block module of each config family; any other config runs the Qwen2 block
_BLOCKS = ((Lfm2Config, lfm2), (MoonlightConfig, moonlight))


def block(cfg: BackboneConfig):
    """The model family's module behind the block interface (see the module
    docstring), chosen by the config's class."""
    return next((mod for kind, mod in _BLOCKS if isinstance(cfg, kind)), qwen2)


def slot_cache_len(cfg: BackboneConfig) -> int:
    """Physical per-slot cache length of the serving path: the logical
    context plus the reconcile slack, a multiple of BLOCK_T (2304 at Air),
    or of 512 for int4 (2560 at Air), as in the JAX package."""
    return round_up(cfg.max_context + CACHE_SLACK, 512 if cfg.kv_dtype == "int4" else BLOCK_T)


def segment_align(cache: bb.KVCache) -> int:
    """Step counts a staged segment over `cache` must be multiples of."""
    return SEGMENT_ALIGN_INT4 if cache.int4 else SEGMENT_ALIGN


@dataclasses.dataclass
class SlotState:
    cache: bb.KVCache  # [L, B, T, K*D] x2 (+ scales; int4: packed; latent: one buffer)
    token: torch.Tensor  # [B] int32 next input token per slot
    lens: torch.Tensor  # [B] int32 cache slots used (left pad + real tokens)
    pad: torch.Tensor  # [B] int32 left pad per slot (attend t >= pad)
    prompt_lens: torch.Tensor  # [B] int32 padded prompt portion (min_new bookkeeping)
    active: torch.Tensor  # [B] bool decoding (not empty, not finished)
    generator: torch.Generator  # sampling noise (the JAX state's `key`)
    # the block's state (`block(cfg).state_shapes`): LFM2's [Lc, B, K-1, D]
    # conv state, and LFM2's and Moonlight's [Lm, 2, E] int64 counts since
    # the last zeroing: [:, 0] the decode rows routed to each expert, [:, 1]
    # the decode steps in which it took any (None where the block has none)
    conv: Optional[torch.Tensor] = None
    expert_rows: Optional[torch.Tensor] = None
    # captured staged segments by step count (CUDA devices; see `_SegmentGraph`)
    graphs: Dict[int, "_SegmentGraph"] = dataclasses.field(default_factory=dict, repr=False,
                                                           compare=False)
    # captured admissions by (G, Lp) (CUDA devices; see `_AdmitGraph`)
    admit_graphs: Dict[Tuple[int, int], "_AdmitGraph"] = dataclasses.field(
        default_factory=dict, repr=False, compare=False)

    @staticmethod
    def create(cfg: BackboneConfig, n_slots: int, device, seed: int = 0) -> "SlotState":
        dev = torch.device(device)
        zeros = lambda dt: torch.zeros((n_slots,), dtype=dt, device=dev)  # noqa: E731
        hybrid = {name: torch.zeros(shape, dtype=dt, device=dev)
                  for name, (shape, dt) in block(cfg).state_shapes(cfg, n_slots).items()}
        return SlotState(
            cache=bb.KVCache.create(cfg, n_slots, max_len=slot_cache_len(cfg), device=dev),
            token=zeros(torch.int32),
            lens=zeros(torch.int32),
            pad=zeros(torch.int32),
            prompt_lens=zeros(torch.int32),
            active=zeros(torch.bool),
            generator=torch.Generator(device=dev).manual_seed(seed),
            **hybrid,
        )


def _prefill_hidden(cfg: BackboneConfig, params, state: SlotState, tokens, true_lens, rows,
                    store):
    """The model's prefill; a recurrent state (LFM2's conv state) goes to
    the state's `rows`."""
    def state_store(i, st):
        state.conv[i, rows] = st

    return block(cfg).prefill_hidden(cfg, params, tokens, true_lens, store, state_store)


@torch.inference_mode()
def prefill_slots(cfg: BackboneConfig, sampling: SamplingConfig, eos_id: int, params,
                  state: SlotState, tokens: torch.Tensor, true_lens: torch.Tensor,
                  slots: torch.Tensor) -> SlotState:
    """Admit a GROUP of LEFT-padded prompts tokens [G, Lp] (int32, true
    lengths true_lens [G]) into cache rows `slots` [G] with one batched
    prefill. Duplicate slots must carry identical rows (the engine pads a
    partial group by repeating its last admission); only the first
    occurrence is written. An int4 cache needs an even Lp. Returns `state`,
    updated. On a CUDA device the admission replays the state's captured
    graph for its shape (`_AdmitGraph`); on the CPU it runs eagerly."""
    if state.cache.int4 and tokens.shape[1] % 2:
        raise ValueError(f"an int4 cache takes even admission buckets, got Lp={tokens.shape[1]}")
    if state.token.is_cuda and graph.supported(sampling):
        return _prefill_slots_graphed(cfg, sampling, eos_id, params, state, tokens, true_lens,
                                      slots)
    return _prefill_slots_eager(cfg, sampling, eos_id, params, state, tokens, true_lens, slots)


@torch.inference_mode()
def _prefill_slots_eager(cfg, sampling, eos_id, params, state, tokens, true_lens, slots):
    """The admission, eagerly: the oracle of the captured admission and the
    CPU's path."""
    for name, t in zip(_SLOT_INPUTS, _admit(cfg, sampling, eos_id, params, state, tokens,
                                            true_lens, slots)):
        setattr(state, name, t)
    return state


def _admit(cfg, sampling, eos_id, params, state: SlotState, tokens, true_lens, slots):
    """One admission group over `state`: the batched prefill, the cache
    writes and the first tokens. Writes the cache (and an LFM2 conv state)
    alone; returns the per-slot tensors of `_SLOT_INPUTS`, all new."""
    G, Lp = tokens.shape
    dev = tokens.device
    cache = state.cache
    # first occurrence of each slot: duplicates take the primary row's values
    ar = torch.arange(G, device=dev)
    src = torch.where(slots[:, None] == slots[None, :], ar[None, :], G).amin(dim=1)
    primary = src == ar
    rows = slots.long()
    L, KD = cache.k.shape[0], cache.k.shape[-1]
    two = not cache.latent  # K and V, or a latent cache's one buffer
    if cache.int4:
        # stack packed K/V [L, G, Lp/2, KD], token-order scales [L, G, Lp] and
        # last-token values [L, G, KD], then ONE scatter_prefill4
        packed = [torch.empty((L, G, Lp // 2, KD), dtype=torch.int8, device=dev) for _ in range(2)]
        scales = [torch.empty((L, G, Lp), dtype=torch.float32, device=dev) for _ in range(2)]
        last = [torch.empty((L, G, KD), dtype=torch.int8, device=dev) for _ in range(2)]

        def store(l, k, v):
            for i, x in enumerate((k, v)):
                q, scales[i][l] = bb.quantize_kv4(x)
                packed[i][l] = bb.pack4_pairs(q)
                last[i][l] = q[:, -1]

        h = _prefill_hidden(cfg, params, state, tokens, true_lens, rows, store)
        attn_ops.scatter_prefill4(cache.k, cache.v, cache.k_scale, cache.v_scale, *packed,
                                  *scales, slots, primary)
        # the prev registers of the direct-write path: a tiny [L, G, KD]
        # write outside the kernel, as in the JAX package; duplicate slots
        # carry identical rows
        cache.k_prev[:, rows] = last[0]
        cache.v_prev[:, rows] = last[1]
        del packed, scales, last
    elif cache.quantized:
        # stack the layers' quantized K/V [L, G, Lp, KD], then ONE scatter_prefill
        new = bb.KVCache(
            k=torch.empty((L, G, Lp, KD), dtype=torch.int8, device=dev),
            v=torch.empty((L, G, Lp, KD), dtype=torch.int8, device=dev) if two else None,
            k_scale=torch.empty((L, G, Lp), dtype=torch.float32, device=dev),
            v_scale=torch.empty((L, G, Lp), dtype=torch.float32, device=dev) if two else None)
        h = _prefill_hidden(cfg, params, state, tokens, true_lens, rows,
                            lambda l, k, v: bb.write_kv(new, l, (), k, v))
        attn_ops.scatter_prefill(cache.k, cache.v, cache.k_scale, cache.v_scale,
                                 new.k, new.v, new.k_scale, new.v_scale, slots, primary)
        del new
    else:
        h = _prefill_hidden(cfg, params, state, tokens, true_lens, rows,
                            lambda l, k, v: bb.write_kv(cache, l, (rows, slice(0, Lp)), k, v))
    first = smp.sample_from_hidden(cfg, sampling, params, h, state.generator, eos_id,
                                   0 < sampling.min_new_tokens)[src]  # [G]
    pads = (Lp - true_lens).to(torch.int32)
    return (state.token.index_put((rows,), first), state.lens.index_fill(0, rows, Lp),
            state.pad.index_put((rows,), pads), state.prompt_lens.index_fill(0, rows, Lp),
            state.active.index_put((rows,), first != eos_id))


def prefill_slot(cfg: BackboneConfig, sampling: SamplingConfig, eos_id: int, params,
                 state: SlotState, tokens: torch.Tensor, true_len: int, slot: int) -> SlotState:
    """Single-request admission: tokens [Lp] LEFT-padded to a bucket."""
    dev = tokens.device
    return prefill_slots(cfg, sampling, eos_id, params, state, tokens[None, :],
                         torch.tensor([true_len], dtype=torch.int32, device=dev),
                         torch.tensor([slot], dtype=torch.int32, device=dev))


@torch.inference_mode()
def retire_slots(state: SlotState, retire_mask: torch.Tensor) -> SlotState:
    """Deactivate the slots of retire_mask [B] bool: inactive, length and
    pad 0 (the staged decode then attends their staging columns alone); an
    LFM2 conv state is zeroed in place."""
    state.active = state.active & ~retire_mask
    if state.conv is not None:
        state.conv.masked_fill_(retire_mask[None, :, None, None], 0)
    state.lens = torch.where(retire_mask, 0, state.lens)
    state.pad = torch.where(retire_mask, 0, state.pad)
    return state


def _in_ctx(cfg: BackboneConfig, lens_new, pad, t_phys: int, n_steps: int):
    """A row may keep decoding while its REAL length (max_context including
    the prompt) and its physical slot usage (the reconcile needs S slots of
    headroom) both have room."""
    return ((lens_new - pad) < cfg.max_context) & (lens_new <= t_phys - n_steps)


def decode_steps(cfg: BackboneConfig, sampling: SamplingConfig, eos_id: int, n_steps: int,
                 params, state: SlotState) -> Tuple[SlotState, torch.Tensor]:
    """Advance every active slot n_steps tokens. Returns (state, tokens
    [B, n_steps] int32). Entries of inactive slots and post-EOS steps are
    `eos_id`. The first token of a fresh admission comes from
    `prefill_slots` (state.token); the engine records it at admission. A
    staged segment on a CUDA device replays the state's captured graph for
    n_steps (`_SegmentGraph`); on the CPU it runs eagerly."""
    if state.cache.quantized:
        align = segment_align(state.cache)
        if n_steps % align or not 0 < n_steps <= attn_ops.SEG_PAD:
            raise ValueError(f"staged segments take a multiple of {align} steps up to "
                             f"SEG_PAD={attn_ops.SEG_PAD}, got {n_steps}")
        if state.token.is_cuda:
            return _decode_steps_graphed(cfg, sampling, eos_id, n_steps, params, state)
        return _decode_steps_staged(cfg, sampling, eos_id, n_steps, params, state)
    return _decode_steps_scatter(cfg, sampling, eos_id, n_steps, params, state)


def _step_head(cfg, sampling, eos_id, params, state, h, lens_new, active, lens, n_steps):
    """Sampling and the per-row bookkeeping after one step's layers (h [B, D]
    final-normed). Returns (next tokens, new active, new lens)."""
    suppress = (lens_new - state.prompt_lens) < sampling.min_new_tokens
    nxt = smp.sample_from_hidden(cfg, sampling, params, h, state.generator, eos_id, suppress)
    in_ctx = _in_ctx(cfg, lens_new, state.pad, state.cache.max_len, n_steps)
    nxt = torch.where(active & in_ctx, nxt, eos_id).to(torch.int32)
    new_active = active & (nxt != eos_id) & in_ctx
    return nxt, new_active, torch.where(active, lens_new, lens)


@torch.inference_mode()
def _decode_steps_staged(cfg, sampling, eos_id, n_steps, params, state):
    """Segment-staged decode (int8 or int4 cache), eagerly: the oracle of
    the captured segment and the CPU's path."""
    outs, state.token, state.lens, state.active = _staged_segment(
        cfg, sampling, eos_id, n_steps, params, state, traced=True)
    return state, outs


def _staged_segment(cfg, sampling, eos_id, n_steps, params, state, traced):
    """One staged segment over `state` (int8 or int4 cache): staging writes
    at column i, the staged attention kernel, one reconcile at segment end.
    Writes the cache alone; returns (outs [B, S], token, lens, active), all
    new tensors. An int4 cache stages unpacked int4 values (`quantize_kv4`)
    and leaves its prev registers untouched: they belong to the direct-write
    path, and the even segment bases make every reconciled byte a complete
    pair. `traced`: each step is a `decode.step` span."""
    cache = state.cache
    quantize = bb.quantize_kv4 if cache.int4 else bb.quantize_kv
    B = state.token.shape[0]
    dev = state.token.device
    L, S, KD = cache.k.shape[0], n_steps, cache.k.shape[-1]
    two = not cache.latent  # K and V, or a latent cache's one buffer
    base = state.lens  # settled length per row, constant over the segment
    active0 = state.active  # rows reconciled at segment end
    stag = bb.KVCache(  # staging: [L, B, S, KD] values, [L, B, SEG_PAD] scales
        k=torch.zeros((L, B, S, KD), dtype=torch.int8, device=dev),
        v=torch.zeros((L, B, S, KD), dtype=torch.int8, device=dev) if two else None,
        k_scale=torch.zeros((L, B, attn_ops.SEG_PAD), dtype=torch.float32, device=dev),
        v_scale=torch.zeros((L, B, attn_ops.SEG_PAD), dtype=torch.float32, device=dev)
        if two else None)
    outs = torch.empty((B, S), dtype=torch.int32, device=dev)
    blk = block(cfg)
    layers = blk.layer_params(cfg, params)
    token, lens, active = state.token, state.lens, state.active
    for i in range(S):
        def attend(l, q, k, v, i=i):
            # write-then-attend: column i is written before the kernel reads [0, i]
            bb.write_kv(stag, l, (slice(None), i), k, v, quantize=quantize)
            if cache.latent:
                return attn_ops.mla_decode_staged(
                    q, cache.k, cache.k_scale, stag.k, stag.k_scale, l, i, base, state.pad,
                    cfg.softmax_scale, cfg.kv_lora_rank)
            return attn_ops.decode_attention_staged(
                q, cache.k, cache.v, cache.k_scale, cache.v_scale, stag.k, stag.v,
                stag.k_scale, stag.v_scale, l, i, base, state.pad)

        with span("decode.step") if traced else contextlib.nullcontext():
            # RoPE position: the real tokens before this one
            h = blk.decode_hidden(cfg, params, layers, token, lens - state.pad, attend, state)
            token, active, lens = _step_head(cfg, sampling, eos_id, params, state, h,
                                             lens + 1, active, lens, n_steps)
            outs[:, i] = token

    # every column of every row active at segment start, even past an EOS
    reconcile = attn_ops.reconcile_segment4 if cache.int4 else attn_ops.reconcile_segment
    reconcile(cache.k, cache.v, cache.k_scale, cache.v_scale, stag.k, stag.v, stag.k_scale,
              stag.v_scale, base, active0)
    return outs, token, lens, active


_SLOT_INPUTS = ("token", "lens", "pad", "prompt_lens", "active")


class _SlotGraph(graph.SegmentGraph):
    """A graph over a `SlotState`: static per-slot tensors of its own,
    copied in from each call's state (`_load`), and the state's cache and
    generator, and the block's conv state and expert counts, baked in and
    written in place. Its `args` end with the params; `serves` tells
    whether a call may replay it."""

    def __init__(self, state: SlotState, *args, **attrs):
        super().__init__(*args, **attrs)
        self.buffers = _state_buffers(state)
        self.static = dataclasses.replace(
            state, graphs={}, admit_graphs={},
            **{n: getattr(state, n).clone() for n in _SLOT_INPUTS})

    def serves(self, cfg, sampling, eos_id, params, state: SlotState) -> bool:
        c, s, e = self.args[:3]
        return (self.args[-1] is params and c == cfg and s == sampling and e == eos_id
                and self.static.generator is state.generator
                and all(a is b for a, b in zip(self.buffers, _state_buffers(state))))

    def _load(self, state: SlotState) -> None:
        for name in _SLOT_INPUTS:
            getattr(self.static, name).copy_(getattr(state, name))


class _SegmentGraph(_SlotGraph):
    """One staged segment of a state (staging allocation, n_steps steps,
    reconcile) over static per-slot buffers of its own, replayable as one
    CUDA graph.

    `run` copies a state's per-slot tensors into the buffers, runs the
    segment and replaces the state's token, lens and active by clones of
    the results: the state's tensors are never written. The body bakes in
    n_steps, the config, the params, the sampling config and eos_id."""

    outputs = ("token", "lens", "active")

    def __init__(self, cfg, sampling, eos_id, n_steps, params, state: SlotState):
        super().__init__(state, cfg, sampling, eos_id, n_steps, params, steps=n_steps)

    def body(self, traced: bool = False):
        """The segment over the static buffers (the captured body)."""
        return _staged_segment(*self.args, self.static, traced)

    def run(self, state: SlotState, segment) -> Tuple[SlotState, torch.Tensor]:
        self._load(state)
        outs, token, lens, active = segment()
        state.token, state.lens, state.active = token.clone(), lens.clone(), active.clone()
        return state, outs.clone()


class _AdmitGraph(_SlotGraph):
    """One admission shape of a state (G rows, bucket Lp) over static
    inputs (tokens [G, Lp], true lengths and slots [G]) and per-slot
    buffers of its own, replayable as one CUDA graph.

    `run` copies the call's inputs and the state's per-slot tensors into
    the buffers, runs the admission and replaces all five per-slot tensors
    of the state by clones of the results; the cache and an LFM2 conv state
    are written in place. A state's admission graphs share one memory pool:
    they replay one at a time on one stream, and each replay's results are
    cloned out before the next."""

    kind = "admit"
    outputs = _SLOT_INPUTS

    def __init__(self, cfg, sampling, eos_id, params, state: SlotState, G: int, Lp: int,
                 pool=None):
        super().__init__(state, cfg, sampling, eos_id, params, rows=G, bucket=Lp)
        self.pool = pool
        dev = state.token.device
        self.inputs = (torch.zeros((G, Lp), dtype=torch.int32, device=dev),
                       torch.zeros((G,), dtype=torch.int32, device=dev),
                       torch.zeros((G,), dtype=torch.int32, device=dev))

    def body(self, traced: bool = False):
        """The admission over the static buffers (the captured body)."""
        return _admit(*self.args, self.static, *self.inputs)

    def run(self, state: SlotState, segment, tokens, true_lens, slots) -> Tuple[SlotState, None]:
        self._load(state)
        for mine, t in zip(self.inputs, (tokens, true_lens, slots)):
            mine.copy_(t)
        for name, t in zip(_SLOT_INPUTS, segment()):
            setattr(state, name, t.clone())
        return state, None


def _state_buffers(state: SlotState) -> tuple:
    """The buffers a segment or an admission writes in place: the cache, and
    the block's conv state and expert counts."""
    cache = state.cache
    return tuple(getattr(cache, f.name) for f in dataclasses.fields(cache)) + (
        state.conv, state.expert_rows)


def _replay_or_capture(store: dict, key, make, cfg, sampling, eos_id, params,
                       state: SlotState, *inputs):
    """The graph `store` keeps for `key`, replayed if it serves the call;
    else `make()`'s graph, captured by this call and kept."""
    g = store.pop(key, None)
    if g is not None and g.serves(cfg, sampling, eos_id, params, state):
        store[key] = g
        return g.replay(state, *inputs)
    g = make()
    out = g.capture(state, *inputs)
    store[key] = g  # kept once captured
    return out


@torch.inference_mode()
def _decode_steps_graphed(cfg, sampling, eos_id, n_steps, params, state):
    """A staged segment on a CUDA device: the replay of the state's graph for
    n_steps, captured on the first call (`_SegmentGraph`)."""
    if not graph.supported(sampling):
        return _decode_steps_staged(cfg, sampling, eos_id, n_steps, params, state)
    return _replay_or_capture(
        state.graphs, n_steps,
        lambda: _SegmentGraph(cfg, sampling, eos_id, n_steps, params, state),
        cfg, sampling, eos_id, params, state)


def _prefill_slots_graphed(cfg, sampling, eos_id, params, state, tokens, true_lens, slots):
    """An admission on a CUDA device: the replay of the state's graph for
    the group's shape, captured on the shape's first call (`_AdmitGraph`),
    in the memory pool of the state's other admission graphs."""
    store = state.admit_graphs
    G, Lp = tokens.shape

    def make():
        pool = next(iter(store.values())).pool if store else torch.cuda.graph_pool_handle()
        return _AdmitGraph(cfg, sampling, eos_id, params, state, G, Lp, pool)

    state, _ = _replay_or_capture(store, (G, Lp), make, cfg, sampling, eos_id, params, state,
                                  tokens, true_lens, slots)
    return state


@torch.inference_mode()
def _decode_steps_scatter(cfg, sampling, eos_id, n_steps, params, state):
    """Direct per-row cache writes at each row's own length (float caches;
    the staged path's oracle for int8 and int4), then `decode_attention`."""
    cache = state.cache
    B = state.token.shape[0]
    ar = torch.arange(B, device=state.token.device)
    outs = torch.empty((B, n_steps), dtype=torch.int32, device=state.token.device)
    blk = block(cfg)
    layers = blk.layer_params(cfg, params)
    for i in range(n_steps):
        with span("decode.step"):
            write_at = torch.clamp(state.lens, max=cache.max_len - 1)  # [B] per-row write slot
            lens_new = write_at + 1  # attend [pad, lens_new), the fresh token included

            def attend(l, q, k, v, cols=write_at.long(), lens_new=lens_new):
                if cache.int4:
                    bb.write_kv4_rows(cache, l, cols, k, v)
                else:
                    bb.write_kv(cache, l, (ar, cols), k, v)
                return attn_ops.decode_attention(q, cache.k, cache.v, l, lens_new, state.pad,
                                                 cache.k_scale, cache.v_scale)

            h = blk.decode_hidden(cfg, params, layers, state.token, write_at - state.pad,
                                  attend, state)
            state.token, state.active, state.lens = _step_head(
                cfg, sampling, eos_id, params, state, h, lens_new, state.active, state.lens,
                n_steps)
            outs[:, i] = state.token
    return state, outs
