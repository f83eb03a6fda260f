"""Attention for the backbone and the serving engine's quantized KV caches.

Seven functions, each with a CUDA kernel (`csrc/decode_attention.cu`,
`csrc/prefill_attention.cu`, `csrc/staged_attention.cu`, `csrc/slot_copy.cu`)
and a plain PyTorch version of the same function. The wrapper picks by the
tensors' device alone: a CPU tensor takes the plain version, a CUDA tensor
launches the kernel (or raises).

* `decode_attention` — one layer of the stacked cache [L, B, T, K*D]
  (bf16/f32 values, or int8 values with per-token f32 scales [L, B, T], or
  int4 nibble pairs [L, B, T/2, K*D] with deinterleaved scales [L, B, T]);
  query q [B, K, G, D] attends the slots [pad, lens) of its row.
* `prefill_attention` — causal, left-pad-masked GQA self-attention over a
  fresh window: q [B, S, H, D], k/v [B, S, K, D], pad rows zeroed.
* `decode_attention_staged` — the serving decode: settled int8 or int4
  cache [pad, base) plus the segment's staging columns [0, step].
* `reconcile_segment` / `reconcile_segment4` — fold a segment's staging
  into the cache slots [base, base + S) of the rows active at segment
  start, in place (int4: packing the staged pairs into bytes).
* `scatter_prefill` / `scatter_prefill4` — write an admission group's
  prompt K/V into the cache rows `slots`, slots [0, Lp), first occurrence
  of each slot only, in place.
* `mla_decode_staged` — the serving decode of absorbed multi-head latent
  attention (`csrc/mla_decode.cu`, port-only): 16 query heads over the
  int8 latent cache's settled rows [pad, base) plus the staging columns
  [0, step].

A latent cache (`backbone.KVCache` in latent mode) has one buffer: its
reconcile and admission write take all_v, v_scale and the staging V as
None and move the K buffer alone, through the same kernels.

An int4 cache is told from an int8 one as the JAX package tells it: its
scale rows are twice as long as its byte axis (`is_int4`).

Counterparts: `neutts_tpu.ops.attention.decode_attention_stacked`,
`prefill_attention`, `decode_attention_staged`, `reconcile_segment`,
`reconcile_segment4`, `scatter_prefill` and `scatter_prefill4` (the TPU
kernels); `decode_attention_xla`, `backbone._attend_block_dense`,
`decode_attention_staged_xla`, `reconcile_segment_xla` and
`reconcile_segment4(use_pallas=False)` (their XLA oracles).
"""

from __future__ import annotations

import torch

from neutts_tpu_torch.ops import _build

MASK_VALUE = -1e30  # finite: a fully masked row stays finite (never NaN)
SMEM_LIMIT = 232_448  # dynamic shared memory one block may use on Hopper
# Staging scale buffers of a serving segment are [L, B, SEG_PAD] with columns
# [0, S) live (the JAX layout, kept at the public boundary); S <= SEG_PAD.
SEG_PAD = 128


def _check_int32(name: str, *tensors) -> None:
    for t in tensors:
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: index tensors must be int32, got {t.dtype}")


def _check_decode_geometry(name: str, G: int, D: int) -> None:
    if G > 16 or D > 128:
        raise ValueError(f"{name}: G={G}, D={D} exceed the kernel's shared memory")


def _check_aligned(name: str, *tensors) -> None:
    """16-byte vector loads need 16-byte aligned buffers."""
    for t in tensors:
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"{name}: buffers must be 16-byte aligned")


def is_int4(all_k, k_scale) -> bool:
    """An int4 cache: scale rows twice the byte axis (JAX attention.py:389)."""
    return k_scale is not None and k_scale.shape[-1] == 2 * all_k.shape[2]


def _dequant_layer(all_c, scale, layer: int):
    """f32 [B, T, KD] of one layer of an int8 or int4 cache."""
    if is_int4(all_c, scale):
        from neutts_tpu_torch.models.backbone import dequant_kv4

        return dequant_kv4(all_c[layer], scale[layer])
    return all_c[layer].float() * scale[layer][..., None]


# --- decode ------------------------------------------------------------------


def decode_attention(q, all_k, all_v, layer: int, lens, pad, k_scale=None, v_scale=None):
    """Flash-decode over layer `layer` of the stacked cache.

    q [B, K, G, D] (f32/bf16); all_k/all_v [L, B, T, K*D] in q's dtype, or
    int8 with k_scale/v_scale [L, B, T] f32, or int4 nibble pairs
    [L, B, T/2, K*D] with deinterleaved k_scale/v_scale [L, B, T]; lens/pad
    [B] int32. Returns [B, K, G, D] in q's dtype."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, all_k, all_v, layer, lens, pad, k_scale, v_scale)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    return _decode_attention_cuda(q, all_k, all_v, layer, lens, pad, k_scale, v_scale)


def decode_attention_plain(q, all_k, all_v, layer: int, lens, pad, k_scale=None, v_scale=None):
    """The same function step by step in torch: dequantize, f32 scores and
    softmax over the masked slots, f32 probability-weighted sum, cast to q's
    dtype."""
    B, K, G, D = q.shape
    if k_scale is not None:
        ck, cv = _dequant_layer(all_k, k_scale, layer), _dequant_layer(all_v, v_scale, layer)
    else:
        ck, cv = all_k[layer].float(), all_v[layer].float()
    T = ck.shape[1]
    ck = ck.reshape(B, T, K, D)
    cv = cv.reshape(B, T, K, D)
    t = torch.arange(T, device=q.device)
    mask = (t[None, :] < lens[:, None]) & (t[None, :] >= pad[:, None])  # [B, T]
    s = torch.einsum("bkgd,btkd->bkgt", q.float(), ck) * D**-0.5
    s = torch.where(mask[:, None, None, :], s, torch.tensor(MASK_VALUE, device=q.device))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bkgt,btkd->bkgd", p, cv).to(q.dtype)


MAX_SPLIT = 32  # csrc/flash_decode.cuh: chunks of one (row, KV head)'s range
_split_ws: dict = {}


def decode_splits(B: int, K: int, T: int, device) -> int:
    """NSPLIT of the split-K decode kernel: enough blocks to fill the card's
    SMs (about four per SM), from B * K alone, never more than one per
    64-token tile of T nor MAX_SPLIT. It never reads `lens`, which would
    wait on the device."""
    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(-(-T // 64), MAX_SPLIT, 4 * n_sm // (B * K)))


def _split_workspace(device, stream: int, B: int, K: int, G: int, D: int, nparts: int):
    """The f32 partials and the zeroed per-(row, KV head) counters of the
    split-K merge (csrc/flash_decode.cuh), made once per (device, stream, B,
    K, G, D, partials per row and head): decode attention (#1, NSPLIT
    partials) and staged decode (#2, NSPLIT + 1) share it at equal keys.
    That is safe because each launch leaves the counters at 0 and launches
    on one stream run in order. A CUDA graph bakes in the workspace of the
    stream it was captured on, so it is replayed on that stream alone
    (`runtime/graph.py` `_capture_stream`)."""
    key = (device.index, stream, B, K, G, D, nparts)
    ws = _split_ws.get(key)
    if ws is None:
        ws = _split_ws[key] = (
            torch.empty(B * K * nparts * (G * D + 2 * G), dtype=torch.float32, device=device),
            torch.zeros(B * K, dtype=torch.int32, device=device),
        )
    return ws


def _decode_attention_cuda(q, all_k, all_v, layer, lens, pad, k_scale, v_scale):
    name = "decode_attention"
    _build.check_no_grad(name, q, all_k, all_v, k_scale, v_scale)
    B, K, G, D = q.shape
    L, Bc, T, KD = all_k.shape
    quant = all_k.dtype == torch.int8
    int4 = quant and is_int4(all_k, k_scale)
    T = 2 * T if int4 else T
    _build.check_inputs(name, q, all_k, all_v, lens, pad, k_scale, v_scale)
    _check_int32(name, lens, pad)
    if all_v.shape != all_k.shape or Bc != B or KD != K * D or not 0 <= layer < L:
        raise ValueError(f"{name}: q {tuple(q.shape)} vs cache {tuple(all_k.shape)}, layer {layer}")
    if lens.shape != (B,) or pad.shape != (B,):
        raise ValueError(f"{name}: lens/pad must be [{B}]")
    if q.dtype not in (torch.float32, torch.bfloat16) or all_v.dtype != all_k.dtype:
        raise TypeError(f"{name}: q {q.dtype}, cache {all_k.dtype}/{all_v.dtype}")
    if quant:
        if k_scale is None or v_scale is None:
            raise ValueError(f"{name}: an int8 or int4 cache needs k_scale and v_scale")
        for s in (k_scale, v_scale):
            if s.dtype != torch.float32 or s.shape != (L, B, T):
                raise ValueError(f"{name}: scales must be f32 [{L}, {B}, {T}]")
    elif all_k.dtype != q.dtype or k_scale is not None:
        raise TypeError(f"{name}: a float cache must match q's dtype and take no scales")
    _check_decode_geometry(name, G, D)
    if D % 16:
        raise ValueError(f"{name}: D={D} must be a multiple of 16 (16-byte cache loads)")
    _check_aligned(name, all_k, all_v)
    out = torch.empty_like(q)
    stream = _build.stream_of(q.device)
    nsplit = decode_splits(B, K, T, q.device)
    ws, counters = _split_workspace(q.device, stream, B, K, G, D, nsplit)
    fn = _build.bind("decode_attention.cu", "neutts_decode_attention", 10, 9)
    with torch.cuda.device(q.device):
        rc = fn(
            q.data_ptr(), all_k.data_ptr(), all_v.data_ptr(),
            _build.ptr(k_scale), _build.ptr(v_scale), lens.data_ptr(), pad.data_ptr(),
            out.data_ptr(), _build.ptr(ws), _build.ptr(counters), B, K, G, D, T, int(layer),
            nsplit, _build.DTYPE_CODE[q.dtype],
            _build.DT_I4 if int4 else _build.DTYPE_CODE[all_k.dtype], stream,
        )
    _build.check(rc, name)
    mode = "int4" if int4 else "int8" if quant else "bf16"
    _build.launches[f"decode_attention_{mode}"] += 1
    return out


# --- prefill -----------------------------------------------------------------

PREFILL_BF16_D = (16, 32, 64, 128, 192)  # head widths of the bf16 tensor-core kernel


def prefill_tile(G: int, D: int, dtype) -> dict:
    """The block shape csrc/prefill_attention.cu launches for G query heads
    per KV head, head width D and dtype (f32 or bf16): query positions and
    heads per block, threads, dynamic shared bytes (needs the built kernel)."""
    import ctypes

    fn = _build.bind("prefill_attention.cu", "neutts_prefill_tile", 0, 3)  # (G, D, dtype, int*)
    shape = (ctypes.c_int * 4)()
    _build.check(fn(G, D, _build.DTYPE_CODE[dtype], ctypes.addressof(shape)), "prefill_tile")
    return dict(zip(("query_positions", "heads", "threads", "smem_bytes"), shape))


def prefill_attention(q, k, v, pads):
    """Causal left-pad-masked GQA attention over a fresh window.

    q [B, S, H, D], k/v [B, S, K, D] (one float dtype), pads [B] int32.
    Returns [B, S, H, D] in q's dtype with the pad rows (i < pads[b]) zero."""
    if q.device.type == "cpu":
        return prefill_attention_plain(q, k, v, pads)
    if q.device.type != "cuda":
        raise ValueError(f"prefill_attention: unsupported device {q.device}")
    return _prefill_attention_cuda(q, k, v, pads)


def prefill_attention_plain(q, k, v, pads):
    """The same function step by step: f32 scores, -1e30 outside the
    causal/left-pad mask, f32 softmax and PV, pad rows zeroed."""
    B, S, H, D = q.shape
    K = k.shape[2]
    G = H // K
    idx = torch.arange(S, device=q.device)
    mask = (idx[None, None, :] <= idx[None, :, None]) & (
        idx[None, None, :] >= pads[:, None, None]
    )  # [B, S(query), S(key)]
    qg = q.float().reshape(B, S, K, G, D)
    s = torch.einsum("bskgd,btkd->bkgst", qg, k.float()) * D**-0.5
    s = torch.where(mask[:, None, None], s, torch.tensor(MASK_VALUE, device=q.device))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", p, v.float()).reshape(B, S, H, D)
    valid = idx[None, :] >= pads[:, None]  # [B, S]
    return torch.where(valid[:, :, None, None], out, 0.0).to(q.dtype)


def _prefill_attention_cuda(q, k, v, pads):
    name = "prefill_attention"
    _build.check_no_grad(name, q, k, v)
    B, S, H, D = q.shape
    K = k.shape[2]
    _build.check_inputs(name, q, k, v, pads)
    _check_int32(name, pads)
    if k.shape != (B, S, K, D) or v.shape != k.shape or H % K or pads.shape != (B,):
        raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name}: q/k/v must share one float dtype")
    G = H // K
    if q.dtype == torch.bfloat16:  # tensor cores; cp.async of k/v, bf16 pairs of q/out
        if D not in PREFILL_BF16_D:
            raise ValueError(f"{name}: bf16 takes D in {PREFILL_BF16_D}, got {D}")
        _check_aligned(name, k, v)
        if q.data_ptr() % 4:
            raise ValueError(f"{name}: q must be 4-byte aligned")
    else:
        R = G * (16 if G <= 8 else 8)  # query rows per block, as the f32 kernel picks
        if 4 * (2 * R * D + 64 * (2 * D + 1) + 64 * R + 3 * R) > SMEM_LIMIT:
            raise ValueError(f"{name}: G={G}, D={D} exceed the kernel's shared memory")
    out = torch.empty_like(q)
    fn = _build.bind("prefill_attention.cu", "neutts_prefill_attention", 5, 6)
    with torch.cuda.device(q.device):
        rc = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), pads.data_ptr(), out.data_ptr(),
            B, S, K, G, D, _build.DTYPE_CODE[q.dtype], _build.stream_of(q.device),
        )
    _build.check(rc, name)
    _build.launches["prefill_attention"] += 1
    return out


# --- staged decode (serving segments) -------------------------------------------


def decode_attention_staged(q, all_k, all_v, k_scale, v_scale, stag_k, stag_v, stag_ks, stag_vs,
                            layer: int, step: int, base, pad):
    """Flash-decode over the settled cache [pad, base) of layer `layer` plus
    the staging columns [0, step] of the current segment.

    q [B, K, G, D] (f32/bf16); all_k/all_v int8 [L, B, T, K*D] with f32
    k_scale/v_scale [L, B, T], or int4 nibble pairs [L, B, T/2, K*D] with
    deinterleaved k_scale/v_scale [L, B, T]; stag_k/stag_v int8
    [L, B, S, K*D] (unpacked int4 values for an int4 cache) with f32
    stag_ks/stag_vs [L, B, SEG_PAD] (columns [0, S) live); base/pad [B]
    int32. Returns [B, K, G, D] in q's dtype."""
    args = (q, all_k, all_v, k_scale, v_scale, stag_k, stag_v, stag_ks, stag_vs, layer, step,
            base, pad)
    if q.device.type == "cpu":
        return decode_attention_staged_plain(*args)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention_staged: unsupported device {q.device}")
    return _decode_attention_staged_cuda(*args)


def decode_attention_staged_plain(q, all_k, all_v, k_scale, v_scale, stag_k, stag_v, stag_ks,
                                  stag_vs, layer: int, step: int, base, pad):
    """The XLA oracle's steps: dequantize, concatenate the staging after the
    cache, mask to [pad, base) u [T, T + step], f32 softmax and PV."""
    B, K, G, D = q.shape
    S = stag_k.shape[2]
    ck, cv = _dequant_layer(all_k, k_scale, layer), _dequant_layer(all_v, v_scale, layer)
    T = ck.shape[1]
    sk = stag_k[layer].float() * stag_ks[layer][:, :S, None]
    sv = stag_v[layer].float() * stag_vs[layer][:, :S, None]
    ck2 = torch.cat([ck, sk], dim=1).reshape(B, T + S, K, D)
    cv2 = torch.cat([cv, sv], dim=1).reshape(B, T + S, K, D)
    t = torch.arange(T + S, device=q.device)
    valid = ((t[None, :] < base[:, None]) & (t[None, :] >= pad[:, None])) | (
        (t[None, :] >= T) & (t[None, :] <= T + step)
    )  # [B, T + S]
    s = torch.einsum("bkgd,btkd->bkgt", q.float(), ck2) * D**-0.5
    s = torch.where(valid[:, None, None, :], s, torch.tensor(MASK_VALUE, device=q.device))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bkgt,btkd->bkgd", p, cv2).to(q.dtype)


def _check_staging(name, all_k, all_v, k_scale, v_scale, stag_k, stag_v, stag_ks, stag_vs):
    """Shapes and types of an int8 or int4 cache and a segment's staging
    buffers; returns (L, B, T, KD, S) with T in tokens."""
    L, B, T, KD = all_k.shape
    T = 2 * T if is_int4(all_k, k_scale) else T
    S = stag_k.shape[2]
    if _one_buffer(all_v, v_scale, stag_v, stag_vs) != (all_v is None):
        raise ValueError(f"{name}: a latent cache takes all_v, v_scale, stag_v and stag_vs "
                         "as None together")
    if (stag_k.shape != (L, B, S, KD) or all_v is not None and (
            all_v.shape != all_k.shape or stag_v.shape != stag_k.shape)):
        raise ValueError(f"{name}: cache {tuple(all_k.shape)}, staging {tuple(stag_k.shape)}")
    if not 0 < S <= SEG_PAD:
        raise ValueError(f"{name}: {S} staging columns, at most SEG_PAD={SEG_PAD}")
    for t in (all_k, all_v, stag_k, stag_v):
        if t is not None and t.dtype != torch.int8:
            raise TypeError(f"{name}: cache and staging values must be int8, got {t.dtype}")
    for t, shape in ((k_scale, (L, B, T)), (v_scale, (L, B, T)), (stag_ks, (L, B, SEG_PAD)),
                     (stag_vs, (L, B, SEG_PAD))):
        if t is None:
            continue
        if t.dtype != torch.float32 or t.shape != shape:
            raise ValueError(f"{name}: scales must be f32 {list(shape)}, got {t.dtype} "
                             f"{list(t.shape)}")
    return L, B, T, KD, S


def _decode_attention_staged_cuda(q, all_k, all_v, k_scale, v_scale, stag_k, stag_v, stag_ks,
                                  stag_vs, layer, step, base, pad):
    name = "decode_attention_staged"
    _build.check_no_grad(name, q, all_k, all_v, k_scale, v_scale, stag_k, stag_v, stag_ks,
                         stag_vs)
    int4 = is_int4(all_k, k_scale)
    B, K, G, D = q.shape
    _build.check_inputs(name, q, all_k, all_v, k_scale, v_scale, stag_k, stag_v, stag_ks,
                        stag_vs, base, pad)
    _check_int32(name, base, pad)
    L, Bc, T, KD, S = _check_staging(name, all_k, all_v, k_scale, v_scale, stag_k, stag_v,
                                     stag_ks, stag_vs)
    if Bc != B or KD != K * D or not 0 <= layer < L or not 0 <= step < S:
        raise ValueError(f"{name}: q {tuple(q.shape)} vs cache {tuple(all_k.shape)}, "
                         f"layer {layer}, step {step} of {S}")
    if base.shape != (B,) or pad.shape != (B,):
        raise ValueError(f"{name}: base/pad must be [{B}]")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: q must be f32 or bf16, got {q.dtype}")
    _check_decode_geometry(name, G, D)
    if D % 16:
        raise ValueError(f"{name}: D={D} must be a multiple of 16 (16-byte cache loads)")
    _check_aligned(name, all_k, all_v, stag_k, stag_v)
    out = torch.empty_like(q)
    stream = _build.stream_of(q.device)
    nsplit = decode_splits(B, K, T, q.device)  # + one partial for the staging columns
    ws, counters = _split_workspace(q.device, stream, B, K, G, D, nsplit + 1)
    fn = _build.bind("staged_attention.cu", "neutts_decode_attention_staged", 14, 12)
    with torch.cuda.device(q.device):
        rc = fn(
            q.data_ptr(), all_k.data_ptr(), all_v.data_ptr(), k_scale.data_ptr(),
            v_scale.data_ptr(), stag_k.data_ptr(), stag_v.data_ptr(), stag_ks.data_ptr(),
            stag_vs.data_ptr(), base.data_ptr(), pad.data_ptr(), out.data_ptr(), ws.data_ptr(),
            counters.data_ptr(), B, K, G, D, T, S, SEG_PAD, int(layer), int(step), nsplit,
            _build.DTYPE_CODE[q.dtype], int(int4), stream,
        )
    _build.check(rc, name)
    _build.launches[name + ("_int4" if int4 else "")] += 1
    return out


# --- slot copies: segment reconcile and admission write --------------------------


def _check_copy_buffers(name: str, KD: int, *tensors) -> None:
    """The 16-byte vector copies of csrc/slot_copy.cu need KD % 16 == 0 and
    16-byte aligned value buffers."""
    if KD % 16:
        raise ValueError(f"{name}: K*D={KD} must be a multiple of 16")
    _check_aligned(name, *tensors)


def _one_buffer(*v_buffers) -> bool:
    """True when every V buffer given is None (a latent cache)."""
    return all(t is None for t in v_buffers)


def _check_reconcile(name, all_k, all_v, k_scale, v_scale, stag_k, stag_v, stag_ks, stag_vs,
                     base, active):
    """The CUDA reconcile wrappers' checks; returns (L, B, T, KD, S)."""
    _build.check_inputs(name, all_k, all_v, k_scale, v_scale, stag_k, stag_v, stag_ks, stag_vs,
                        base, active)
    _check_int32(name, base)
    L, B, T, KD, S = _check_staging(name, all_k, all_v, k_scale, v_scale, stag_k, stag_v,
                                    stag_ks, stag_vs)
    if base.shape != (B,) or active.shape != (B,) or active.dtype != torch.bool:
        raise ValueError(f"{name}: base must be int32 [{B}] and active bool [{B}]")
    _check_copy_buffers(name, KD, all_k, all_v, stag_k, stag_v)
    return L, B, T, KD, S


def reconcile_segment(all_k, all_v, k_scale, v_scale, stag_k, stag_v, stag_ks, stag_vs,
                      base, active):
    """Copy one segment's staging (values [L, B, S, K*D], scales
    [L, B, SEG_PAD]) into cache slots [base[b], base[b] + S) of every row b
    with active[b], IN PLACE; other rows stay untouched. Columns outside
    [0, T) are dropped. A latent cache passes the four V buffers as None.
    Returns (all_k, all_v, k_scale, v_scale)."""
    args = (all_k, all_v, k_scale, v_scale, stag_k, stag_v, stag_ks, stag_vs, base, active)
    if all_k.device.type == "cpu":
        return reconcile_segment_plain(*args)
    if all_k.device.type != "cuda":
        raise ValueError(f"reconcile_segment: unsupported device {all_k.device}")
    return _reconcile_segment_cuda(*args)


def reconcile_segment_plain(all_k, all_v, k_scale, v_scale, stag_k, stag_v, stag_ks, stag_vs,
                            base, active):
    B, T = all_k.shape[1], all_k.shape[2]
    S = stag_k.shape[2]
    cols = base[:, None] + torch.arange(S, device=base.device)  # [B, S]
    hit = active[:, None] & (cols >= 0) & (cols < T)
    rows = torch.arange(B, device=base.device)[:, None].expand(B, S)[hit]
    c = cols[hit]
    all_k[:, rows, c] = stag_k[:, hit]
    k_scale[:, rows, c] = stag_ks[:, :, :S][:, hit]
    if all_v is not None:
        all_v[:, rows, c] = stag_v[:, hit]
        v_scale[:, rows, c] = stag_vs[:, :, :S][:, hit]
    return all_k, all_v, k_scale, v_scale


def _reconcile_segment_cuda(all_k, all_v, k_scale, v_scale, stag_k, stag_v, stag_ks, stag_vs,
                            base, active):
    name = "reconcile_segment"
    _build.check_no_grad(name, all_k, all_v, k_scale, v_scale, stag_k, stag_v, stag_ks, stag_vs)
    if is_int4(all_k, k_scale):
        raise TypeError(f"{name}: an int4 cache takes reconcile_segment4")
    L, B, T, KD, S = _check_reconcile(name, all_k, all_v, k_scale, v_scale, stag_k, stag_v,
                                      stag_ks, stag_vs, base, active)
    fn = _build.bind("slot_copy.cu", "neutts_reconcile_segment", 10, 6)
    with torch.cuda.device(all_k.device):
        rc = fn(
            stag_k.data_ptr(), _build.ptr(stag_v), stag_ks.data_ptr(), _build.ptr(stag_vs),
            base.data_ptr(), active.data_ptr(), all_k.data_ptr(), _build.ptr(all_v),
            k_scale.data_ptr(), _build.ptr(v_scale), L, B, T, S, KD, SEG_PAD,
            _build.stream_of(all_k.device),
        )
    _build.check(rc, name)
    _build.launches[name] += 1
    return all_k, all_v, k_scale, v_scale


def reconcile_geometry(L: int, B: int, S: int, KD: int, int4: bool) -> dict:
    """The launch of csrc/slot_copy.cu's reconcile for L layers, B cache
    rows, S staging steps and K*D = KD, int8 or int4 (needs the built
    library): grid (rows, layer groups), layers per block, value threads and
    scale threads per block, value vectors per thread and buffer in flight."""
    import ctypes

    fn = _build.bind("slot_copy.cu", "neutts_reconcile_geometry", 0, 4)  # (L, S, KD, int4, int*)
    shape = (ctypes.c_int * 4)()
    _build.check(fn(L, S, KD, int(int4), ctypes.addressof(shape)), "reconcile_geometry")
    layers, value_threads, scale_threads, unroll = shape
    return {"grid": (B, -(-L // layers)), "layers_per_block": layers,
            "value_threads": value_threads, "scale_threads": scale_threads,
            "vectors_in_flight": unroll}


def scatter_prefill(all_k, all_v, k_scale, v_scale, new_k, new_v, new_ks, new_vs, slots,
                    primary):
    """Admission-group cache write, IN PLACE: for each admission row j with
    primary[j], prompt values new_k/new_v [L, G, Lp, K*D] (int8) and scales
    new_ks/new_vs [L, G, Lp] (f32) land in cache row slots[j] (in [0, B)),
    slots [0, Lp). Rows not named stay untouched. A latent cache passes the
    four V buffers as None. Returns (all_k, all_v, k_scale, v_scale)."""
    args = (all_k, all_v, k_scale, v_scale, new_k, new_v, new_ks, new_vs, slots, primary)
    if all_k.device.type == "cpu":
        return scatter_prefill_plain(*args)
    if all_k.device.type != "cuda":
        raise ValueError(f"scatter_prefill: unsupported device {all_k.device}")
    return _scatter_prefill_cuda(*args)


def scatter_prefill_plain(all_k, all_v, k_scale, v_scale, new_k, new_v, new_ks, new_vs, slots,
                          primary):
    n = min(new_k.shape[2], all_k.shape[2])
    rows = slots[primary].long()
    all_k[:, rows, :n] = new_k[:, primary, :n]
    k_scale[:, rows, :n] = new_ks[:, primary, :n]
    if all_v is not None:
        all_v[:, rows, :n] = new_v[:, primary, :n]
        v_scale[:, rows, :n] = new_vs[:, primary, :n]
    return all_k, all_v, k_scale, v_scale


def _check_scatter(name, pack, all_k, all_v, k_scale, v_scale, new_k, new_v, new_ks, new_vs,
                   slots, primary):
    """The CUDA admission-write wrappers' checks, for value rows that hold
    `pack` tokens each (1: int8, 2: int4 pairs); returns (L, B, T, KD, G,
    Lp) with T and Lp in tokens."""
    _build.check_inputs(name, all_k, all_v, k_scale, v_scale, new_k, new_v, new_ks, new_vs,
                        slots, primary)
    _check_int32(name, slots)
    L, B, T, KD = all_k.shape
    G, Lp = new_ks.shape[1], new_ks.shape[2]
    T *= pack
    if _one_buffer(all_v, v_scale, new_v, new_vs) != (all_v is None) or (
            all_v is None and pack != 1):
        raise ValueError(f"{name}: an int8 latent cache takes all_v, v_scale, new_v and "
                         "new_vs as None together")
    if (new_k.shape != (L, G, Lp // pack, KD) or all_v is not None and (
            all_v.shape != all_k.shape or new_v.shape != new_k.shape)):
        raise ValueError(f"{name}: cache {tuple(all_k.shape)}, prompt K/V {tuple(new_k.shape)}")
    for t in (all_k, all_v, new_k, new_v):
        if t is not None and t.dtype != torch.int8:
            raise TypeError(f"{name}: values must be int8, got {t.dtype}")
    for t, shape in ((k_scale, (L, B, T)), (v_scale, (L, B, T)), (new_ks, (L, G, Lp)),
                     (new_vs, (L, G, Lp))):
        if t is None:
            continue
        if t.dtype != torch.float32 or t.shape != shape:
            raise ValueError(f"{name}: scales must be f32 {list(shape)}")
    if slots.shape != (G,) or primary.shape != (G,) or primary.dtype != torch.bool:
        raise ValueError(f"{name}: slots must be int32 [{G}] and primary bool [{G}]")
    _check_copy_buffers(name, KD, all_k, all_v, new_k, new_v)
    return L, B, T, KD, G, Lp


def _scatter_prefill_cuda(all_k, all_v, k_scale, v_scale, new_k, new_v, new_ks, new_vs, slots,
                          primary):
    name = "scatter_prefill"
    _build.check_no_grad(name, all_k, all_v, k_scale, v_scale, new_k, new_v, new_ks, new_vs)
    L, B, T, KD, G, Lp = _check_scatter(name, 1, all_k, all_v, k_scale, v_scale, new_k, new_v,
                                        new_ks, new_vs, slots, primary)
    fn = _build.bind("slot_copy.cu", "neutts_scatter_prefill", 10, 6)
    with torch.cuda.device(all_k.device):
        rc = fn(
            new_k.data_ptr(), _build.ptr(new_v), new_ks.data_ptr(), _build.ptr(new_vs),
            slots.data_ptr(), primary.data_ptr(), all_k.data_ptr(), _build.ptr(all_v),
            k_scale.data_ptr(), _build.ptr(v_scale), L, G, B, T, Lp, KD,
            _build.stream_of(all_k.device),
        )
    _build.check(rc, name)
    _build.launches[name] += 1
    return all_k, all_v, k_scale, v_scale


# --- int4 slot copies ---------------------------------------------------------------


def reconcile_segment4(all_k, all_v, k_scale, v_scale, stag_k, stag_v, stag_ks, stag_vs,
                       base, active):
    """int4 segment reconcile, IN PLACE: for every row b with active[b], pack
    the staging pairs (2j, 2j + 1) (unpacked int4 values, int8
    [L, B, S, K*D]) into bytes lo + 16*hi at byte rows [base[b]/2,
    base[b]/2 + S/2) of the packed cache [L, B, T/2, K*D], and write the S
    staged scales ([L, B, SEG_PAD], columns [0, S) live) to their
    deinterleaved columns t/2 + (t&1)*T/2 of [L, B, T]. Columns outside the
    buffers are dropped; other rows stay untouched. Needs an even S and an
    even base in every active row: the plain version raises on an odd one,
    the kernel stops with a device-side trap (reported at the next
    synchronisation), as no wait for the device may happen in a segment.
    Returns (all_k, all_v, k_scale, v_scale)."""
    args = (all_k, all_v, k_scale, v_scale, stag_k, stag_v, stag_ks, stag_vs, base, active)
    if stag_k.shape[2] % 2:
        raise ValueError(f"reconcile_segment4: S={stag_k.shape[2]} must be even")
    if all_k.device.type == "cpu":
        return reconcile_segment4_plain(*args)
    if all_k.device.type != "cuda":
        raise ValueError(f"reconcile_segment4: unsupported device {all_k.device}")
    return _reconcile_segment4_cuda(*args)


def reconcile_segment4_plain(all_k, all_v, k_scale, v_scale, stag_k, stag_v, stag_ks,
                             stag_vs, base, active):
    from neutts_tpu_torch.models.backbone import deint4_index, pack4_pairs

    B, Tb = all_k.shape[1], all_k.shape[2]
    T, S = k_scale.shape[2], stag_k.shape[2]
    if S % 2 or bool((base[active] & 1).any()):
        raise ValueError("reconcile_segment4: S and the bases of active rows must be even")
    ar = torch.arange(B, device=base.device)[:, None]
    cols = (base >> 1)[:, None] + torch.arange(S // 2, device=base.device)  # byte rows [B, S/2]
    hit = active[:, None] & (cols >= 0) & (cols < Tb)
    rows, c = ar.expand(B, S // 2)[hit], cols[hit]
    all_k[:, rows, c] = pack4_pairs(stag_k)[:, hit]
    all_v[:, rows, c] = pack4_pairs(stag_v)[:, hit]
    sc = deint4_index(base[:, None] + torch.arange(S, device=base.device), T // 2)  # [B, S]
    hit = active[:, None] & (sc >= 0) & (sc < T)
    rows, c = ar.expand(B, S)[hit], sc[hit]
    k_scale[:, rows, c] = stag_ks[:, :, :S][:, hit]
    v_scale[:, rows, c] = stag_vs[:, :, :S][:, hit]
    return all_k, all_v, k_scale, v_scale


def _reconcile_segment4_cuda(all_k, all_v, k_scale, v_scale, stag_k, stag_v, stag_ks,
                             stag_vs, base, active):
    name = "reconcile_segment4"
    _build.check_no_grad(name, all_k, all_v, k_scale, v_scale, stag_k, stag_v, stag_ks, stag_vs)
    if not is_int4(all_k, k_scale):
        raise TypeError(f"{name}: needs an int4 cache (scale rows twice the byte axis)")
    L, B, T, KD, S = _check_reconcile(name, all_k, all_v, k_scale, v_scale, stag_k, stag_v,
                                      stag_ks, stag_vs, base, active)
    fn = _build.bind("slot_copy.cu", "neutts_reconcile_segment4", 10, 6)
    with torch.cuda.device(all_k.device):
        rc = fn(
            stag_k.data_ptr(), stag_v.data_ptr(), stag_ks.data_ptr(), stag_vs.data_ptr(),
            base.data_ptr(), active.data_ptr(), all_k.data_ptr(), all_v.data_ptr(),
            k_scale.data_ptr(), v_scale.data_ptr(), L, B, T, S, KD, SEG_PAD,
            _build.stream_of(all_k.device),
        )
    _build.check(rc, name)
    _build.launches[name] += 1
    return all_k, all_v, k_scale, v_scale


def scatter_prefill4(all_k, all_v, k_scale, v_scale, new_k, new_v, new_ks, new_vs, slots,
                     primary):
    """int4 admission-group cache write, IN PLACE: for each admission row j
    with primary[j], packed prompt bytes new_k/new_v [L, G, Lp/2, K*D] land
    in byte rows [0, Lp/2) of cache row slots[j] ([L, B, T/2, K*D]), and its
    TOKEN-ORDER scales new_ks/new_vs [L, G, Lp] land deinterleaved: even
    tokens at [0, Lp/2), odd ones at [T/2, T/2 + Lp/2) of [L, B, T]. Rows
    not named stay untouched. Needs an even Lp <= T. Returns (all_k, all_v,
    k_scale, v_scale)."""
    args = (all_k, all_v, k_scale, v_scale, new_k, new_v, new_ks, new_vs, slots, primary)
    Lp, T = new_ks.shape[2], k_scale.shape[2]
    if Lp % 2 or Lp > T or new_k.shape[2] != Lp // 2:
        raise ValueError(f"scatter_prefill4: Lp={Lp} must be even and at most T={T}, with "
                         f"Lp/2 packed rows (got {new_k.shape[2]})")
    if all_k.device.type == "cpu":
        return scatter_prefill4_plain(*args)
    if all_k.device.type != "cuda":
        raise ValueError(f"scatter_prefill4: unsupported device {all_k.device}")
    return _scatter_prefill4_cuda(*args)


def scatter_prefill4_plain(all_k, all_v, k_scale, v_scale, new_k, new_v, new_ks, new_vs, slots,
                           primary):
    n, half = new_k.shape[2], k_scale.shape[2] // 2
    rows = slots[primary].long()
    all_k[:, rows, :n] = new_k[:, primary]
    all_v[:, rows, :n] = new_v[:, primary]
    for scales, new in ((k_scale, new_ks), (v_scale, new_vs)):
        scales[:, rows, :n] = new[:, primary, 0::2]
        scales[:, rows, half : half + n] = new[:, primary, 1::2]
    return all_k, all_v, k_scale, v_scale


def _scatter_prefill4_cuda(all_k, all_v, k_scale, v_scale, new_k, new_v, new_ks, new_vs, slots,
                           primary):
    name = "scatter_prefill4"
    _build.check_no_grad(name, all_k, all_v, k_scale, v_scale, new_k, new_v, new_ks, new_vs)
    L, B, T, KD, G, Lp = _check_scatter(name, 2, all_k, all_v, k_scale, v_scale, new_k, new_v,
                                        new_ks, new_vs, slots, primary)
    fn = _build.bind("slot_copy.cu", "neutts_scatter_prefill4", 10, 6)
    with torch.cuda.device(all_k.device):
        rc = fn(
            new_k.data_ptr(), new_v.data_ptr(), new_ks.data_ptr(), new_vs.data_ptr(),
            slots.data_ptr(), primary.data_ptr(), all_k.data_ptr(), all_v.data_ptr(),
            k_scale.data_ptr(), v_scale.data_ptr(), L, G, B, T, Lp, KD,
            _build.stream_of(all_k.device),
        )
    _build.check(rc, name)
    _build.launches[name] += 1
    return all_k, all_v, k_scale, v_scale


# --- multi-head latent attention: staged decode -----------------------------------

MLA_HEADS, MLA_ROW, MLA_VALUE = 16, 576, 512  # the shape csrc/mla_decode.cu takes
_mla_ws: dict = {}


def mla_decode_staged(q, lat, lat_scale, stag, stag_scale, layer: int, step: int, base, pad,
                      scale: float, v_dim: int):
    """Absorbed multi-head latent attention over the settled latent rows
    [pad, base) of layer `layer` plus the staging columns [0, step] of the
    current segment, in one softmax.

    q [B, H, R] (per head: the absorbed latent query, then the rotary
    query; f32/bf16); lat int8 [L, B, T, R] with f32 lat_scale [L, B, T]
    (one scale a token over its row); stag int8 [L, B, S, R] with f32
    stag_scale [L, B, SEG_PAD] (columns [0, S) live); base/pad [B] int32.
    score = scale x (q . row); the output is the probability-weighted sum of
    the rows' first v_dim values: [B, H, v_dim] in q's dtype. The CUDA
    kernel takes bf16 q at H 16, R 576, v_dim 512."""
    args = (q, lat, lat_scale, stag, stag_scale, layer, step, base, pad, scale, v_dim)
    if q.device.type == "cpu":
        return mla_decode_staged_plain(*args)
    if q.device.type != "cuda":
        raise ValueError(f"mla_decode_staged: unsupported device {q.device}")
    return _mla_decode_staged_cuda(*args)


def mla_decode_staged_plain(q, lat, lat_scale, stag, stag_scale, layer: int, step: int, base,
                            pad, scale: float, v_dim: int):
    """The same function step by step: dequantize the rows, concatenate the
    staging after the cache, mask to [pad, base) u [T, T + step], f32
    scores, softmax and the sum over the rows' first v_dim values."""
    S = stag.shape[2]
    rows = lat[layer].float() * lat_scale[layer][..., None]  # [B, T, R]
    T = rows.shape[1]
    st = stag[layer].float() * stag_scale[layer][:, :S, None]
    rows = torch.cat([rows, st], dim=1)
    t = torch.arange(T + S, device=q.device)
    valid = ((t[None, :] < base[:, None]) & (t[None, :] >= pad[:, None])) | (
        (t[None, :] >= T) & (t[None, :] <= T + step))  # [B, T + S]
    s = torch.einsum("bhr,btr->bht", q.float(), rows) * scale
    s = torch.where(valid[:, None, :], s, torch.tensor(MASK_VALUE, device=q.device))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bht,btv->bhv", p, rows[..., :v_dim]).to(q.dtype)


def _mla_workspace(device, stream: int, B: int, nparts: int):
    """The f32 partials and zeroed per-row counters of the MLA kernel's
    split-K merge, made once per (device, stream, B, partials): each launch
    leaves the counters at 0 (see `_split_workspace`)."""
    key = (device.index, stream, B, nparts)
    ws = _mla_ws.get(key)
    if ws is None:
        ws = _mla_ws[key] = (
            torch.empty(B * nparts * (MLA_HEADS * MLA_VALUE + 2 * MLA_HEADS),
                        dtype=torch.float32, device=device),
            torch.zeros(B, dtype=torch.int32, device=device),
        )
    return ws


def _mla_decode_staged_cuda(q, lat, lat_scale, stag, stag_scale, layer, step, base, pad, scale,
                            v_dim):
    name = "mla_decode"
    _build.check_no_grad(name, q, lat, lat_scale, stag, stag_scale)
    _build.check_inputs(name, q, lat, lat_scale, stag, stag_scale, base, pad)
    _check_int32(name, base, pad)
    B, H, R = q.shape
    L, Bc, T, Rc = lat.shape
    S = stag.shape[2]
    if (H, R, v_dim) != (MLA_HEADS, MLA_ROW, MLA_VALUE) or q.dtype != torch.bfloat16:
        raise ValueError(f"{name}: the kernel takes bf16 q [B, {MLA_HEADS}, {MLA_ROW}] and "
                         f"v_dim {MLA_VALUE}, got {q.dtype} {tuple(q.shape)}, v_dim {v_dim}")
    if (Bc, Rc) != (B, R) or stag.shape != (L, B, S, R) or not 0 < S <= SEG_PAD:
        raise ValueError(f"{name}: q {tuple(q.shape)}, cache {tuple(lat.shape)}, staging "
                         f"{tuple(stag.shape)}")
    if lat.dtype != torch.int8 or stag.dtype != torch.int8:
        raise TypeError(f"{name}: latent rows must be int8")
    for t, shape in ((lat_scale, (L, B, T)), (stag_scale, (L, B, SEG_PAD))):
        if t.dtype != torch.float32 or t.shape != shape:
            raise ValueError(f"{name}: scales must be f32 {list(shape)}")
    if base.shape != (B,) or pad.shape != (B,) or not 0 <= layer < L or not 0 <= step < S:
        raise ValueError(f"{name}: base/pad [{B}], layer {layer} of {L}, step {step} of {S}")
    _check_aligned(name, lat, stag)
    if q.data_ptr() % 4:
        raise ValueError(f"{name}: q must be 4-byte aligned")
    out = torch.empty((B, H, v_dim), dtype=q.dtype, device=q.device)
    stream = _build.stream_of(q.device)
    nsplit = decode_splits(B, 1, T, q.device)  # + one partial for the staging columns
    ws, counters = _mla_workspace(q.device, stream, B, nsplit + 1)
    fn = _build.bind("mla_decode.cu", "neutts_mla_decode", 10, 7, 1)
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), lat.data_ptr(), lat_scale.data_ptr(), stag.data_ptr(),
                stag_scale.data_ptr(), base.data_ptr(), pad.data_ptr(), out.data_ptr(),
                ws.data_ptr(), counters.data_ptr(), B, T, S, SEG_PAD, int(layer), int(step),
                nsplit, float(scale) * 1.4426950408889634, stream)
    _build.check(rc, name)
    _build.launches[name] += 1
    return out
