"""Qwen2.5-style speech-LM backbone in PyTorch (port of
`neutts_tpu.models.backbone`): inference, and the training forward
`forward_train`.

Parameters are the JAX package's tree as a dict of tensors: per-layer
weights stacked on a leading layer axis under params["layers"], quantized
projections as {"q": int8 [.., D, F], "s": f32 [.., F]} dicts, the fused
int8 QKV copy under "wqkv". Layers run in a Python loop over that axis.

The KV cache keeps the JAX layout, [L, B, T, K*D] values with [L, B, T] f32
scales in int8 mode, nibble-pair-packed bytes [L, B, T/2, K*D] with
deinterleaved [L, B, T] scales and [L, B, K*D] prev registers in int4 mode,
and is written IN PLACE where the JAX code used `lax.dynamic_update_slice`
on a scan carry. Prompts are left-padded, so every row's decode write lands
at one shared slot.

Kernels on this path (ops/): `prefill_attention` for every prefill,
`decode_attention` (bf16, int8 or int4 cache) for every layer of every
decode step, and — for int8 weights at B*S >= FUSED_MIN_M token rows —
`fused_qkv` and `fused_mlp`. On CPU tensors each of them runs its plain
PyTorch version. `forward_train` goes through none of them: it is plain
differentiable torch on every device (the kernels have no backward).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from neutts_tpu_torch.config import BackboneConfig, MoonlightConfig, require_qwen2, round_up
from neutts_tpu_torch.models.checkpoint import param_count, tree_to  # noqa: F401 (API)
from neutts_tpu_torch.ops import attention as attn_ops
from neutts_tpu_torch.ops import mlp as mlp_ops
from neutts_tpu_torch.parallel import tensor as tp_ops

Params = Dict[str, object]
_PROJ = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
# the int8 weights of the fused QKV and MLP kernels: stored K-major
_FUSED_PROJ = ("wqkv", "w_gate", "w_up", "w_down")
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


# --- initialisation and quantization -------------------------------------------


def init_params(cfg: BackboneConfig, seed: int = 0, device="cuda", dtype=None) -> Params:
    """Random weights from `seed`, made on `device` (the JAX init's shapes and
    scales: N(0, 1/fan_in) projections, N(0, 0.02^2) embedding, zero biases,
    unit norms). The random streams differ from jax.random's."""
    dtype = dtype or torch_dtype(cfg.dtype)
    gen = torch.Generator(device=device).manual_seed(seed)
    D, L = cfg.hidden_size, cfg.n_layers
    Q, KV, Fd, V = cfg.q_dim, cfg.kv_dim, cfg.intermediate_size, cfg.padded_vocab

    def dense(shape, scale=None):
        scale = scale if scale is not None else shape[-2] ** -0.5
        w = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
        return (w * scale).to(dtype)

    def const(shape, value):
        return torch.full(shape, value, device=device, dtype=dtype)

    params: Params = {
        "embed": dense((V, D), scale=0.02),
        "layers": {
            "attn_norm": const((L, D), 1.0),
            "wq": dense((L, D, Q)),
            "bq": const((L, Q), 0.0),
            "wk": dense((L, D, KV)),
            "bk": const((L, KV), 0.0),
            "wv": dense((L, D, KV)),
            "bv": const((L, KV), 0.0),
            "wo": dense((L, Q, D)),
            "mlp_norm": const((L, D), 1.0),
            "w_gate": dense((L, D, Fd)),
            "w_up": dense((L, D, Fd)),
            "w_down": dense((L, Fd, D)),
        },
        "final_norm": const((D,), 1.0),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense((D, V), scale=0.02)
    return params


def quantize_weight(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """w [..., D, F] -> {"q": int8 [..., D, F], "s": f32 [..., F]}, symmetric
    per-output-channel scales."""
    wf = w.float()
    # a tensor divisor: CUDA turns division by a Python number into a product
    # with its reciprocal, which rounds unlike the CPU's division, and the
    # int8 weights must not depend on the device that made them
    s = torch.clamp(wf.abs().amax(dim=-2), min=1e-8) / torch.tensor(127.0, device=wf.device)
    q = torch.clamp(torch.round(wf / s[..., None, :]), -127, 127).to(torch.int8)
    return {"q": q, "s": s}


def k_major(q: torch.Tensor) -> torch.Tensor:
    """An int8 weight [..., K, N] as a view of [..., N, K] storage (K
    contiguous): the operand layout of the int8 tensor cores in the fused
    QKV and MLP kernels (`mma` takes B column-major). No copy if it is
    already so. `torch._int_mm` takes the view as its transposed operand."""
    return q if q.mT.is_contiguous() else q.mT.contiguous().mT


def fused_weights_k_major(params: Params) -> Params:
    """`params` with the quantized weights of the fused kernels (the fused
    "wqkv", gate, up, down) stored K-major; float weights, and weights
    already K-major, as they are. Quantized trees from elsewhere (a
    checkpoint, the JAX package's arrays) hold them [K, N] row-major. The
    K-major copy replaces the row-major one."""
    layers = params["layers"]
    names = [n for n in _FUSED_PROJ if isinstance(layers.get(n), dict)]
    if all(layers[n]["q"].mT.is_contiguous() for n in names):
        return params
    layers = dict(layers)
    for name in names:
        layers[name] = {**layers[name], "q": k_major(layers[name]["q"])}
    return {**params, "layers": layers}


def prepare_params(params: Params, device) -> Params:
    """A parameter tree as the entry points (`NeuTTS`, `Engine`) run it:
    every tensor on `device`, the fused kernels' quantized weights K-major
    (`fused_weights_k_major`), whether the tree came from `quantize_params`,
    a checkpoint or the JAX package's arrays."""
    return fused_weights_k_major(tree_to(params, device))


def quantize_params(params: Params) -> Params:
    """int8 W8A8 weights: the seven projections and the LM head become
    {"q", "s"} dicts, the MLP's K-major (`k_major`); "wqkv" adds the fused
    [wq | wk | wv] copy, K-major, with an f32 fused bias for the prefill
    `fused_qkv` kernel. The embedding stays."""
    layers = dict(params["layers"])
    for name in _PROJ:
        layers[name] = quantize_weight(layers[name])
    layers["wqkv"] = {  # [N, D] storage made directly: no row-major copy
        "q": torch.cat([layers[n]["q"].mT for n in ("wq", "wk", "wv")], dim=-2).mT,
        "s": torch.cat([layers[n]["s"] for n in ("wq", "wk", "wv")], dim=-1).contiguous(),
        "b": torch.cat([params["layers"][n].float() for n in ("bq", "bk", "bv")], dim=-1),
    }
    out = dict(params)
    out["layers"] = layers
    head = params["lm_head"] if "lm_head" in params else params["embed"].T
    out["lm_head"] = quantize_weight(head)
    return fused_weights_k_major(out)


def quantized_weights(params: Params) -> bool:
    return isinstance(params["layers"]["wq"], dict)


def layer_params(params: Params, l: int) -> Params:
    """Layer l's slice of every stacked weight (views, no copy)."""
    def take(v):
        return {k: take(x) for k, x in v.items()} if isinstance(v, dict) else v[l]

    return {name: take(v) for name, v in params["layers"].items()}


# --- primitives ----------------------------------------------------------------


class _MatmulF32(torch.autograd.Function):
    """x [M, K] @ w [K, N], 16-bit operands, f32 result (`aten::mm.dtype`,
    which has no derivative of its own); the backward multiplies in the
    operands' dtype."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return torch.mm(x, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)
        return (g @ w.T if ctx.needs_input_grad[0] else None,
                x.T @ g if ctx.needs_input_grad[1] else None)


def matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [..., K] @ w [K, N] with an f32 result, as JAX's
    `jnp.dot(..., preferred_element_type=f32)`: 16-bit products are not
    rounded to 16 bits first. On CUDA one library GEMM writes f32 from bf16
    operands (no f32 copy of the weight); on the CPU the operands are
    upcast."""
    if x.dtype == torch.float32 and w.dtype == torch.float32:
        return torch.matmul(x, w)
    x2 = x.reshape(-1, x.shape[-1])
    if x.device.type != "cuda":
        y = torch.matmul(x2.float(), w.float())
    elif torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        y = _MatmulF32.apply(x2, w)
    else:
        y = torch.mm(x2, w, out_dtype=torch.float32)
    return y.reshape(*x.shape[:-1], -1)


def bmm_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Batched x [N, M, K] @ w [N, K, P] with an f32 result, by
    `matmul_f32`'s rule: one library call writes f32 from 16-bit operands on
    CUDA (`aten::bmm.dtype`); the CPU upcasts the operands."""
    if x.dtype == torch.float32 and w.dtype == torch.float32:
        return torch.bmm(x, w)
    if x.device.type != "cuda":
        return torch.bmm(x.float(), w.float())
    return torch.bmm(x, w, out_dtype=torch.float32)


def _mm(x: torch.Tensor, w) -> torch.Tensor:
    """Projection dispatch, returns f32.

    Plain tensor w: `matmul_f32`, the f32 result of the operands in their
    own dtype (JAX's `preferred_element_type=f32`).
    Quantized dict w: per-token int8 activation quant (amax/127, division),
    an exact int8 x int8 -> int32 product, dequant by xs * ws."""
    if isinstance(w, dict):
        lead = x.shape[:-1]
        xf = x.reshape(-1, x.shape[-1]).float()
        xs = torch.clamp(xf.abs().amax(dim=-1, keepdim=True), min=1e-8) / 127.0
        xq = torch.clamp(torch.round(xf / xs), -127, 127).to(torch.int8)
        acc = mlp_ops.int8_matmul(xq, w["q"])
        return (acc.float() * xs * w["s"]).reshape(*lead, -1)
    return matmul_f32(x, w)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * weight.float()).to(x.dtype)


def rope_tables(head_dim: int, theta: float, positions: torch.Tensor):
    """positions [...] int -> (cos, sin) each [..., head_dim/2] f32."""
    half = head_dim // 2
    ar = torch.arange(half, dtype=torch.float32, device=positions.device)
    freqs = torch.pow(float(theta), -ar / half)  # a scalar base: no host-to-device copy
    angles = positions.float()[..., None] * freqs
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [..., n_heads, head_dim]; HALF-SPLIT ("rotate_half", HF Qwen2)
    convention: pairs (i, i + head_dim/2). The codec's RoPE instead rotates
    interleaved pairs (2i, 2i+1), see models/codec.py."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., None, :].to(x.dtype)
    s = sin[..., None, :].to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def _logits(cfg: BackboneConfig, params: Params, x: torch.Tensor, trim: bool = True, tp=None):
    """LM head. trim=True: exact f32 logits over the real vocab [..., vocab].
    trim=False: the padded width, in cfg.logits_dtype (pad ids are masked
    among the sampling candidates). Under tensor parallelism (`tp`, the
    Mesh) a tied head is replicated and an untied one split on the vocab:
    its logits are gathered over the ranks."""
    V = cfg.vocab_size
    if "lm_head" in params and tp_ops.active(tp):
        full = tp_ops.gather_from_tp(_mm(tp_ops.copy_to_tp(x, tp), params["lm_head"]), tp)
        return full[..., :V] if trim else full.to(torch_dtype(cfg.logits_dtype))
    head = params["lm_head"] if "lm_head" in params else params["embed"].T
    if isinstance(head, dict):
        if trim:  # the padded product, sliced: `_int_mm` needs N % 8 == 0
            return _mm(x, head)[:, :V]
        return _mm(x, head).to(torch_dtype(cfg.logits_dtype))
    if trim:
        return matmul_f32(x, head[:, :V])
    return matmul_f32(x, head).to(torch_dtype(cfg.logits_dtype))


def add_speech_head(cfg: BackboneConfig, params: Params) -> Params:
    """Attach a pre-sliced speech-vocab head (EOS then the speech codes,
    padded to a multiple of 256 columns) for constrained decode."""
    if "lm_head_speech" in params:
        return params
    lay = cfg.layout
    lo = lay.speech_gen_end
    assert lay.speech_base == lo + 1, "speech head requires EOS right before the speech codes"
    width = cfg.vocab_size - lo
    extra = round_up(width, 256) - width
    head = params["lm_head"] if "lm_head" in params else params["embed"].T
    out = dict(params)
    if isinstance(head, dict):
        out["lm_head_speech"] = {
            "q": F.pad(head["q"][:, lo : lo + width], (0, extra)).contiguous(),
            "s": F.pad(head["s"][lo : lo + width], (0, extra)),
        }
    else:
        out["lm_head_speech"] = F.pad(head[:, lo : lo + width], (0, extra)).contiguous()
    return out


def speech_head_width(cfg: BackboneConfig) -> int:
    """Number of REAL columns in the speech head (EOS + codebook)."""
    return cfg.vocab_size - cfg.layout.speech_gen_end


def _logits_speech(cfg: BackboneConfig, params: Params, x: torch.Tensor):
    """Speech-head logits [B, padded width] in cfg.logits_dtype; column 0
    is EOS, column 1 + c is speech code c."""
    return _mm(x, params["lm_head_speech"]).to(torch_dtype(cfg.logits_dtype))


# --- KV cache ------------------------------------------------------------------


@dataclass
class KVCache:
    """Preallocated cache: k/v [L, B, T, K*D]; in int8 mode (cfg.kv_dtype ==
    "int8") int8 values with per-token symmetric f32 scales [L, B, T].

    int4 mode (cfg.kv_dtype == "int4"): k/v hold ARITHMETIC-coded nibble
    pairs [L, B, T/2, K*D] (byte t2 = lo + 16*hi codes token 2*t2 as lo and
    2*t2 + 1 as hi), per-token f32 scales DEINTERLEAVED in [L, B, T] (even
    tokens' scales in [0, T/2), odd tokens' in [T/2, T)), and k_prev/v_prev
    [L, B, K*D] int8: the int4 values of each row's last even-parity write,
    which an odd-parity write pairs with. The mode is flagged by k_prev.

    Latent mode (a `MoonlightConfig`): one buffer, k [L, B, T, latent_dim]
    int8 with per-token f32 scales k_scale [L, B, T] over the whole row, and
    no V buffer (v and v_scale None): a token's latent row serves as key
    and, in its first kv_lora_rank values, as value for every head."""

    k: torch.Tensor
    v: Optional[torch.Tensor]
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None
    k_prev: Optional[torch.Tensor] = None
    v_prev: Optional[torch.Tensor] = None

    @staticmethod
    def create(cfg: BackboneConfig, batch: int, max_len: Optional[int] = None,
               device="cuda", dtype=None, kv_heads: Optional[int] = None) -> "KVCache":
        """kv_heads: the KV heads kept (default all; a tensor-parallel rank
        keeps those its query heads read, `parallel.tensor.n_kv_heads`)."""
        T = max_len or cfg.max_context
        L, KD = cfg.n_cache_layers, (kv_heads or cfg.n_kv_heads) * cfg.head_dim
        shape = (L, batch, T, KD)

        def zeros(shape, dt):
            return torch.zeros(shape, dtype=dt, device=device)

        if isinstance(cfg, MoonlightConfig):
            if cfg.kv_dtype != "int8":
                raise ValueError(f"{cfg.name}: the latent cache is int8, got kv_dtype "
                                 f"{cfg.kv_dtype!r}")
            return KVCache(k=zeros((L, batch, T, cfg.latent_dim), torch.int8), v=None,
                           k_scale=zeros((L, batch, T), torch.float32))

        if cfg.kv_dtype == "int8":
            return KVCache(k=zeros(shape, torch.int8), v=zeros(shape, torch.int8),
                           k_scale=zeros((L, batch, T), torch.float32),
                           v_scale=zeros((L, batch, T), torch.float32))
        if cfg.kv_dtype == "int4":
            if T % 2:
                raise ValueError(f"an int4 cache packs token pairs: max_len {T} must be even")
            return KVCache(k=zeros((L, batch, T // 2, KD), torch.int8),
                           v=zeros((L, batch, T // 2, KD), torch.int8),
                           k_scale=zeros((L, batch, T), torch.float32),
                           v_scale=zeros((L, batch, T), torch.float32),
                           k_prev=zeros((L, batch, KD), torch.int8),
                           v_prev=zeros((L, batch, KD), torch.int8))
        if cfg.kv_dtype == "auto":
            raise ValueError("kv_dtype='auto' must be resolved first (config.resolve_kv_dtype)")
        dtype = dtype or torch_dtype(cfg.dtype)
        return KVCache(k=zeros(shape, dtype), v=zeros(shape, dtype))

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    @property
    def int4(self) -> bool:
        return self.k_prev is not None

    @property
    def latent(self) -> bool:
        return self.v is None

    @property
    def max_len(self) -> int:
        return self.k.shape[2] * (2 if self.int4 else 1)


def quantize_kv(x: torch.Tensor):
    """x [..., KD] -> (int8 values [..., KD], f32 scales [...])."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(dim=-1), min=1e-8) / 127.0
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


# --- int4 KV helpers (JAX backbone.py:354-450) ----------------------------------------


def quantize_kv4(x: torch.Tensor):
    """x [..., KD] -> (int4 values in int8 [..., KD], f32 scales [...]):
    symmetric per-token scales amax/7, round-half-even, 15 levels."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(dim=-1), min=1e-8) / 7.0
    q = torch.clamp(torch.round(xf / scale[..., None]), -7, 7)
    return q.to(torch.int8), scale


def pack4(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Two int4-valued ([-7, 7]) int8 tensors -> ARITHMETIC-coded bytes
    lo + 16*hi (range [-119, 119])."""
    return lo + 16 * hi


def unpack4(b: torch.Tensor):
    """Arithmetic-coded bytes -> (lo, hi) int4 values as int8. The shift is
    arithmetic on the signed byte: hi = floor((b + 8) / 16)."""
    hi = (b + 8) >> 4  # b + 8 <= 127: no overflow in int8
    lo = b - 16 * hi
    return lo, hi


def pack4_pairs(q: torch.Tensor) -> torch.Tensor:
    """q [..., S, KD] int4-in-int8 (S even) -> packed [..., S/2, KD]."""
    return pack4(q[..., 0::2, :], q[..., 1::2, :])


def deint4_index(t, half: int):
    """Deinterleaved scale column of token t in a [.., T] scale row whose
    first `half` entries hold even tokens and the rest odd tokens."""
    return (t >> 1) + (t & 1) * half


def scales4_block(sc: torch.Tensor) -> torch.Tensor:
    """sc [..., S] per-token scales (S even) -> deinterleaved [..., S] (even
    tokens first, then odd), the KVCache int4 scale layout."""
    return torch.cat([sc[..., 0::2], sc[..., 1::2]], dim=-1)


def dequant_kv4(cq: torch.Tensor, sc: torch.Tensor) -> torch.Tensor:
    """Packed [B, T/2, KD] + deinterleaved scales [B, T] -> f32 [B, T, KD]
    (token t = 2*t2 + parity)."""
    B, T2, KD = cq.shape
    lo, hi = unpack4(cq)
    q = torch.stack([lo, hi], dim=2).reshape(B, 2 * T2, KD).float()
    st = torch.stack([sc[:, :T2], sc[:, T2:]], dim=2).reshape(B, 2 * T2)
    return q * st[..., None]


def write_kv(cache: KVCache, l: int, at: tuple, kf: torch.Tensor, vf: torch.Tensor,
             quantize=quantize_kv) -> None:
    """Write K/V values kf/vf [..., KD] at layer l, positions `at` (an index
    into the [B, T] axes: a slot, a slot range, or per-row (rows, cols)), in
    place; quantized per token by `quantize` in int8 mode (`quantize_kv4`
    for the int4 staging buffers, which hold unpacked int4 values). A
    latent cache takes its rows as kf, and vf is None.

    int4 cache (`write_kv4_rows` takes per-row slots): `at` is (rows, a
    slice from 0 of even length) for a prompt block, whose packed pairs and
    deinterleaved scales land at once and whose last token seeds the prev
    registers; or (slice(None), t) for one token at a shared slot t: an even
    t writes lo alone (the hi nibble is beyond every row's length), an odd t
    writes prev + 16*q; prev takes q (JAX `write_kv_token`)."""
    if cache.int4:
        rows, cols = at
        half = cache.k_scale.shape[2] // 2
        kq, ksc = quantize_kv4(kf)
        vq, vsc = quantize_kv4(vf)
        if isinstance(cols, slice):
            n = kf.shape[-2]
            if cols.start not in (0, None) or n % 2:
                raise ValueError(f"an int4 cache takes even prompt blocks from slot 0, got {n}")
            for buf, scales, prev, q, sc in ((cache.k, cache.k_scale, cache.k_prev, kq, ksc),
                                             (cache.v, cache.v_scale, cache.v_prev, vq, vsc)):
                buf[l, rows, : n // 2] = pack4_pairs(q)
                scales[l, rows, : n // 2] = sc[..., 0::2]
                scales[l, rows, half : half + n // 2] = sc[..., 1::2]
                prev[l, rows] = q[..., -1, :]
            return
        t2, sidx = cols >> 1, deint4_index(cols, half)
        for buf, scales, prev, q, sc in ((cache.k, cache.k_scale, cache.k_prev, kq, ksc),
                                         (cache.v, cache.v_scale, cache.v_prev, vq, vsc)):
            buf[l, rows, t2] = q if cols % 2 == 0 else pack4(prev[l, rows], q)
            scales[l, rows, sidx] = sc
            prev[l, rows] = q
    elif cache.quantized:
        cache.k[(l, *at)], cache.k_scale[(l, *at)] = quantize(kf)
        if not cache.latent:
            cache.v[(l, *at)], cache.v_scale[(l, *at)] = quantize(vf)
    else:
        cache.k[(l, *at)] = kf.to(cache.k.dtype)
        cache.v[(l, *at)] = vf.to(cache.v.dtype)


def write_kv4_rows(cache: KVCache, l: int, cols: torch.Tensor, kf: torch.Tensor,
                   vf: torch.Tensor) -> None:
    """int4 per-row token write (the serving direct-write path, JAX
    batching.py:471-495): row b's token kf[b]/vf[b] [B, KD] at its own slot
    cols[b]. An even slot writes lo alone, an odd one prev + 16*q; prev
    takes q ONLY on even writes, so an inactive row parked at an odd slot,
    which rewrites its byte every step, keeps pairing with the real token
    before it instead of clobbering that token's nibble."""
    rows = torch.arange(cols.shape[0], device=cols.device)
    even = (cols & 1)[:, None] == 0
    t2, sidx = cols >> 1, deint4_index(cols, cache.k_scale.shape[2] // 2)
    for buf, scales, prev, x in ((cache.k, cache.k_scale, cache.k_prev, kf),
                                 (cache.v, cache.v_scale, cache.v_prev, vf)):
        q, sc = quantize_kv4(x)
        p = prev[l]
        buf[l, rows, t2] = torch.where(even, q, pack4(p, q))
        scales[l, rows, sidx] = sc
        prev[l] = torch.where(even, q, p)


# --- blocks --------------------------------------------------------------------


def _qkv(cfg: BackboneConfig, lp: Params, h, cos, sin, tp=None):
    """h [B, S, D] -> q [B,S,H,Dh], k/v [B,S,K,Dh] with RoPE on q and k.
    Under tensor parallelism (`tp`, the Mesh): the rank's query heads, and
    the KV heads they read (`parallel.tensor.kv_span`)."""
    B, S, _ = h.shape
    Dh = cfg.head_dim
    h = tp_ops.copy_to_tp(h, tp)
    q = _mm(h, lp["wq"]).to(h.dtype) + lp["bq"]
    k = _mm(h, lp["wk"]).to(h.dtype) + lp["bk"]
    v = _mm(h, lp["wv"]).to(h.dtype) + lp["bv"]
    k, v = tp_ops.kv_span(cfg, k, v, tp)
    q = apply_rope(q.reshape(B, S, -1, Dh), cos, sin)
    k = apply_rope(k.reshape(B, S, -1, Dh), cos, sin)
    return q, k, v.reshape(B, S, -1, Dh)


def _attn_out(attn: torch.Tensor, wo, x: torch.Tensor, tp=None) -> torch.Tensor:
    """x + attn [B, S, H*Dh] @ wo; under tensor parallelism the ranks'
    partial products are summed in f32 before the cast."""
    return x + tp_ops.reduce_from_tp(_mm(attn, wo), tp).to(x.dtype)


def _mlp(cfg: BackboneConfig, lp: Params, x: torch.Tensor, tp=None) -> torch.Tensor:
    B, S, D = x.shape
    if isinstance(lp["w_gate"], dict) and B * S >= mlp_ops.FUSED_MIN_M:
        y = mlp_ops.fused_mlp(
            x.reshape(B * S, D), lp["mlp_norm"],
            lp["w_gate"]["q"], lp["w_gate"]["s"], lp["w_up"]["q"], lp["w_up"]["s"],
            lp["w_down"]["q"], lp["w_down"]["s"], eps=cfg.rms_norm_eps,
        )
        return y.reshape(B, S, D)
    h = tp_ops.copy_to_tp(rms_norm(x, lp["mlp_norm"], cfg.rms_norm_eps), tp)
    gate, up = _mm(h, lp["w_gate"]), _mm(h, lp["w_up"])  # f32, as JAX's
    ff = (F.silu(gate) * up).to(x.dtype)
    return x + tp_ops.reduce_from_tp(_mm(ff, lp["w_down"]), tp).to(x.dtype)


def _block_fresh(cfg: BackboneConfig, lp: Params, x, cos, sin, pads, tp=None):
    """Transformer block over a fresh left-padded window (prefill).
    pads: [B] int32 left-pad counts. Returns (x_out, k, v)."""
    B, S, D = x.shape
    if "wqkv" in lp and B * S >= mlp_ops.FUSED_MIN_M:
        flat = mlp_ops.fused_qkv(
            x.reshape(B * S, D), lp["attn_norm"], lp["wqkv"]["q"], lp["wqkv"]["s"],
            lp["wqkv"]["b"], eps=cfg.rms_norm_eps,
        ).reshape(B, S, -1)
        Qd, KVd = cfg.q_dim, cfg.kv_dim
        q = apply_rope(flat[..., :Qd].reshape(B, S, cfg.n_heads, cfg.head_dim), cos, sin)
        k = apply_rope(flat[..., Qd : Qd + KVd].reshape(B, S, cfg.n_kv_heads, cfg.head_dim),
                       cos, sin)
        v = flat[..., Qd + KVd :].reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    else:
        h = rms_norm(x, lp["attn_norm"], cfg.rms_norm_eps)
        q, k, v = _qkv(cfg, lp, h, cos, sin, tp)
    attn = attn_ops.prefill_attention(q.contiguous(), k.contiguous(), v.contiguous(), pads)
    x = _attn_out(attn.reshape(B, S, -1), lp["wo"], x, tp)
    return _mlp(cfg, lp, x, tp), k, v


def _check_tp(cfg: BackboneConfig, params: Params, tp, speech_head: bool = False) -> None:
    """Tensor parallelism runs float weights through the LM head: the JAX
    layout has no entries for the quantized leaves nor the speech head."""
    if tp_ops.active(tp):
        tp_ops.check_tp(cfg, tp.tp)
        if quantized_weights(params) or speech_head:
            raise ValueError("tensor parallelism takes float weights and the LM head: "
                             "quantized weights and the speech head run at tp 1")


def prefill_hidden(cfg: BackboneConfig, params: Params, tokens: torch.Tensor,
                   prompt_lens: torch.Tensor, store, tp=None) -> torch.Tensor:
    """Every layer over left-padded prompts [B, Lp] (true lengths
    prompt_lens [B]); store(l, k, v) keeps layer l's K/V [B, Lp, KD] where
    its caller holds the cache. Returns the final-normed hidden state of the
    last position [B, D]. `tp`: the Mesh of a tensor-parallel rank holding
    `parallel.mesh.shard_params`' slices (KD is then its KV heads'), or
    None."""
    require_qwen2(cfg, "backbone.prefill_hidden")
    B, Lp = tokens.shape
    dev = tokens.device
    pad = (Lp - prompt_lens).to(torch.int32)
    idx = torch.arange(Lp, dtype=torch.int32, device=dev)
    positions = torch.clamp(idx[None, :] - pad[:, None], min=0)
    cos, sin = rope_tables(cfg.head_dim, cfg.rope_theta, positions)
    x = params["embed"].to(torch_dtype(cfg.dtype))[tokens.long()]
    for l in range(cfg.n_layers):
        x, k, v = _block_fresh(cfg, layer_params(params, l), x, cos, sin, pad, tp)
        store(l, k.reshape(B, Lp, -1), v.reshape(B, Lp, -1))
    return rms_norm(x[:, -1, :], params["final_norm"], cfg.rms_norm_eps)


def prefill(cfg: BackboneConfig, params: Params, tokens: torch.Tensor,
            prompt_lens: torch.Tensor, cache: KVCache, speech_head: bool = False, tp=None):
    """Left-padded prompts [B, Lp] (true lengths prompt_lens [B]) -> last
    position logits [B, V]; writes slots [0, Lp) of `cache` in place (an
    int4 cache needs an even Lp). `tp` as in `prefill_hidden`."""
    _check_tp(cfg, params, tp, speech_head)
    at = (slice(None), slice(0, tokens.shape[1]))
    h = prefill_hidden(cfg, params, tokens, prompt_lens,
                       lambda l, k, v: write_kv(cache, l, at, k, v), tp)
    if speech_head:
        return _logits_speech(cfg, params, h), cache
    return _logits(cfg, params, h, tp=tp), cache


def decode_hidden(cfg: BackboneConfig, params: Params, layers, token: torch.Tensor,
                  positions: torch.Tensor, attend, tp=None) -> torch.Tensor:
    """Every layer of one decode step: token [B] at RoPE positions [B].
    `layers` holds each layer's `layer_params`. For layer l,
    attend(l, q [B,K,G,Dh], k [B,KD], v [B,KD]) stores the step's K/V where
    its caller keeps the cache and returns the attention [B,K,G,Dh]. Returns
    the final-normed hidden state [B, D]. `tp` as in `prefill_hidden`: K
    and G are then the rank's."""
    require_qwen2(cfg, "backbone.decode_hidden")
    B = token.shape[0]
    K = tp_ops.n_kv_heads(cfg, tp)
    cos, sin = rope_tables(cfg.head_dim, cfg.rope_theta, positions[:, None])
    x = params["embed"].to(torch_dtype(cfg.dtype))[token.long()[:, None]]
    for l, lp in enumerate(layers):
        h = rms_norm(x, lp["attn_norm"], cfg.rms_norm_eps)
        q, k, v = _qkv(cfg, lp, h, cos, sin, tp)
        a = attend(l, q[:, 0].reshape(B, K, -1, cfg.head_dim).contiguous(),
                   k[:, 0].reshape(B, -1), v[:, 0].reshape(B, -1))
        x = _attn_out(a.to(x.dtype).reshape(B, 1, -1), lp["wo"], x, tp)
        x = _mlp(cfg, lp, x, tp)
    return rms_norm(x[:, 0, :], params["final_norm"], cfg.rms_norm_eps)


def decode_step(cfg: BackboneConfig, params: Params, token: torch.Tensor, cache: KVCache,
                cur_index: int, pad: torch.Tensor, trim_logits: bool = True,
                speech_head: bool = False, tp=None):
    """One decode step: feeds token [B] at cache slot `cur_index` (written
    first, in place), attends [pad, cur_index]; returns (logits [B, V], cache).
    `tp` as in `prefill_hidden`."""
    _check_tp(cfg, params, tp, speech_head)
    lens = torch.full(token.shape, cur_index + 1, dtype=torch.int32, device=token.device)

    def attend(l, q, k, v):
        write_kv(cache, l, (slice(None), cur_index), k, v)
        return attn_ops.decode_attention(q, cache.k, cache.v, l, lens, pad,
                                         cache.k_scale, cache.v_scale)

    layers = [layer_params(params, l) for l in range(cfg.n_layers)]
    h = decode_hidden(cfg, params, layers, token, cur_index - pad, attend, tp)
    if speech_head:
        return _logits_speech(cfg, params, h), cache
    return _logits(cfg, params, h, trim=trim_logits, tp=tp), cache


# --- training forward (JAX backbone.py:861-899) --------------------------------

PREFILL_Q_CHUNK = 128  # query chunk of the dense attention, as the JAX package's


def _attend_dense(q, k, v, mask):
    """q [B, S, H, Dh], k/v [B, T, K, Dh], mask [B, S, T] bool -> [B, S, H, Dh]:
    f32 scores x Dh**-0.5, -1e30 outside the mask (a fully masked row stays
    finite), f32 softmax, probabilities cast to v's dtype for PV (JAX
    `_attend_block_dense`)."""
    B, S, H, Dh = q.shape
    K = k.shape[2]
    qg = q.reshape(B, S, K, H // K, Dh)
    scores = torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float()) * Dh**-0.5
    scores = scores.masked_fill(~mask[:, None, None], -1e30)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bkgst,btkd->bskgd", probs, v).reshape(B, S, H, Dh)


def _attend_train(q, k, v, mask):
    """Dense attention over the whole window, in query chunks of
    PREFILL_Q_CHUNK when S is a larger multiple of it (JAX `_attend_block`
    with no pads or valid flags: the XLA path)."""
    S, C = q.shape[1], PREFILL_Q_CHUNK
    if S > C and S % C == 0:
        return torch.cat([_attend_dense(q[:, i : i + C], k, v, mask[:, i : i + C])
                          for i in range(0, S, C)], dim=1)
    return _attend_dense(q, k, v, mask)


def _block_train(cfg: BackboneConfig, lp: Params, x, cos, sin, mask, tp=None):
    B, S, _ = x.shape
    h = rms_norm(x, lp["attn_norm"], cfg.rms_norm_eps)
    q, k, v = _qkv(cfg, lp, h, cos, sin, tp)
    attn = _attend_train(q, k, v, mask).reshape(B, S, -1)
    x = _attn_out(attn, lp["wo"], x, tp)
    return _mlp(cfg, lp, x, tp)  # float weights: the unfused path


def forward_train(cfg: BackboneConfig, params: Params, tokens: torch.Tensor,
                  attn_mask: torch.Tensor, remat: bool = False, tp=None) -> torch.Tensor:
    """Full-sequence causal forward for training: tokens [B, S] RIGHT-padded,
    attn_mask [B, S] True on real tokens -> logits [B, S, vocab] f32.

    Positions are cumsum(mask) - 1 clamped at 0; the attention mask is
    causal & key-padding. Every op is plain differentiable torch, the same
    on the CPU and the card: no kernel of ops/ runs here. remat=True wraps
    each layer in torch.utils.checkpoint, so the backward recomputes a
    layer's activations instead of keeping all L of them. `tp` as in
    `prefill_hidden`: the collectives are autograd functions, so the
    gradients are those of the rank's slices."""
    require_qwen2(cfg, "training (backbone.forward_train)")
    if quantized_weights(params):
        raise ValueError("forward_train takes float weights: quantized weights are for "
                         "inference")
    _check_tp(cfg, params, tp)
    S = tokens.shape[1]
    m = attn_mask.bool()
    x = params["embed"].to(torch_dtype(cfg.dtype))[tokens.long()]
    positions = torch.clamp(torch.cumsum(m.int(), dim=-1) - 1, min=0)
    cos, sin = rope_tables(cfg.head_dim, cfg.rope_theta, positions)
    idx = torch.arange(S, device=tokens.device)
    mask = (idx[:, None] >= idx[None, :])[None] & m[:, None, :]  # [B, S, S]
    for l in range(cfg.n_layers):
        lp = layer_params(params, l)
        if remat:
            x = torch.utils.checkpoint.checkpoint(_block_train, cfg, lp, x, cos, sin, mask, tp,
                                                  use_reentrant=False)
        else:
            x = _block_train(cfg, lp, x, cos, sin, mask, tp)
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    return _logits(cfg, params, x, tp=tp)
