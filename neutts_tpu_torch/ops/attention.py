"""Attention for the backbone: decode over the KV cache, and prefill.

Two functions, each with a CUDA kernel (`csrc/decode_attention.cu`,
`csrc/prefill_attention.cu`) and a plain PyTorch version of the same
function. The wrapper picks by the tensors' device alone: a CPU tensor takes
the plain version, a CUDA tensor launches the kernel (or raises).

* `decode_attention` — one layer of the stacked cache [L, B, T, K*D]
  (bf16/f32 values, or int8 values with per-token f32 scales [L, B, T]);
  query q [B, K, G, D] attends the slots [pad, lens) of its row.
* `prefill_attention` — causal, left-pad-masked GQA self-attention over a
  fresh window: q [B, S, H, D], k/v [B, S, K, D], pad rows zeroed.

Counterparts: `neutts_tpu.ops.attention.decode_attention_stacked` and
`prefill_attention` (the TPU kernels), `decode_attention_xla` and
`backbone._attend_block_dense` (their XLA oracles).
"""

from __future__ import annotations

import torch

from neutts_tpu_torch.ops import _build

MASK_VALUE = -1e30  # finite: a fully masked row stays finite (never NaN)
SMEM_LIMIT = 232_448  # dynamic shared memory one block may use on Hopper


def _check_int32(name: str, *tensors) -> None:
    for t in tensors:
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: index tensors must be int32, got {t.dtype}")


# --- decode ------------------------------------------------------------------


def decode_attention(q, all_k, all_v, layer: int, lens, pad, k_scale=None, v_scale=None):
    """Flash-decode over layer `layer` of the stacked cache.

    q [B, K, G, D] (f32/bf16); all_k/all_v [L, B, T, K*D] in q's dtype, or
    int8 with k_scale/v_scale [L, B, T] f32; lens/pad [B] int32. Returns
    [B, K, G, D] in q's dtype."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, all_k, all_v, layer, lens, pad, k_scale, v_scale)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    return _decode_attention_cuda(q, all_k, all_v, layer, lens, pad, k_scale, v_scale)


def decode_attention_plain(q, all_k, all_v, layer: int, lens, pad, k_scale=None, v_scale=None):
    """The same function step by step in torch: f32 scores and softmax over
    the masked slots, f32 probability-weighted sum, cast to q's dtype."""
    B, K, G, D = q.shape
    T = all_k.shape[2]
    ck = all_k[layer].float()
    cv = all_v[layer].float()
    if k_scale is not None:
        ck = ck * k_scale[layer][..., None]
        cv = cv * v_scale[layer][..., None]
    ck = ck.reshape(B, T, K, D)
    cv = cv.reshape(B, T, K, D)
    t = torch.arange(T, device=q.device)
    mask = (t[None, :] < lens[:, None]) & (t[None, :] >= pad[:, None])  # [B, T]
    s = torch.einsum("bkgd,btkd->bkgt", q.float(), ck) * D**-0.5
    s = torch.where(mask[:, None, None, :], s, torch.tensor(MASK_VALUE, device=q.device))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bkgt,btkd->bkgd", p, cv).to(q.dtype)


def _decode_attention_cuda(q, all_k, all_v, layer, lens, pad, k_scale, v_scale):
    name = "decode_attention"
    B, K, G, D = q.shape
    L, Bc, T, KD = all_k.shape
    quant = all_k.dtype == torch.int8
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
            raise ValueError(f"{name}: an int8 cache needs k_scale and v_scale")
        for s in (k_scale, v_scale):
            if s.dtype != torch.float32 or s.shape != (L, B, T):
                raise ValueError(f"{name}: scales must be f32 [{L}, {B}, {T}]")
    elif all_k.dtype != q.dtype or k_scale is not None:
        raise TypeError(f"{name}: a float cache must match q's dtype and take no scales")
    if G > 16 or D > 128:
        raise ValueError(f"{name}: G={G}, D={D} exceed the kernel's shared memory")
    out = torch.empty_like(q)
    fn = _build.bind("decode_attention.cu", "neutts_decode_attention", 8, 8)
    with torch.cuda.device(q.device):
        rc = fn(
            q.data_ptr(), all_k.data_ptr(), all_v.data_ptr(),
            _build.ptr(k_scale), _build.ptr(v_scale), lens.data_ptr(), pad.data_ptr(),
            out.data_ptr(), B, K, G, D, T, int(layer),
            _build.DTYPE_CODE[q.dtype], _build.DTYPE_CODE[all_k.dtype], _build.stream_of(q.device),
        )
    _build.check(rc, name)
    _build.launches["decode_attention_int8" if quant else "decode_attention_bf16"] += 1
    return out


# --- prefill -----------------------------------------------------------------


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
    B, S, H, D = q.shape
    K = k.shape[2]
    _build.check_inputs(name, q, k, v, pads)
    _check_int32(name, pads)
    if k.shape != (B, S, K, D) or v.shape != k.shape or H % K or pads.shape != (B,):
        raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name}: q/k/v must share one float dtype")
    G = H // K
    R = G * (16 if G <= 8 else 8)  # query rows per block, as the kernel picks
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
