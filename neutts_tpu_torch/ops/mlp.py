"""W8A8 prefill projections: the fused QKV and the fused SwiGLU MLP.

Each has a CUDA kernel (`csrc/w8a8.cu`) and a plain PyTorch version of the
same function. The wrapper picks by the tensors' device alone: a CPU tensor
takes the plain version, a CUDA tensor launches the kernel (or raises).

Quantization semantics (those of `neutts_tpu.ops.mlp.fused_mlp_xla` and of
the TPU `_qkv_kernel`): symmetric per-token activation scales amax/127 on the
f32 normed activation, quantized by multiplying with the reciprocal scale
and rounding half to even; per-output-channel weight scales; exact int32
accumulation. The backbone takes these paths only for int8 weights and at
least FUSED_MIN_M token rows (prefill); decode stays on `backbone._mm`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from neutts_tpu_torch.ops import _build

# Token rows (B * S) from which the backbone uses the fused kernels, as the
# JAX package does; below it the projections go through backbone._mm.
FUSED_MIN_M = 2048


def quantize_act(h32: torch.Tensor):
    """Per-token symmetric int8 quantization of an f32 activation [..., D]:
    scale = max(amax, 1e-8) / 127 (as amax * (1/127)), q = round(h * (1/scale))
    clipped to [-127, 127]. Returns (int8 [..., D], f32 scales [..., 1])."""
    xs = torch.clamp(h32.abs().amax(dim=-1, keepdim=True), min=1e-8) * (1.0 / 127.0)
    xq = torch.clamp(torch.round(h32 * (1.0 / xs)), -127, 127).to(torch.int8)
    return xq, xs


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 [M, K] @ int8 [K, N] -> exact int32 [M, N] via `torch._int_mm`.
    Its CUDA path refuses M <= 16, so short inputs are padded with zero rows
    (decode runs M = batch) and the result sliced back."""
    M = a.shape[0]
    if a.is_cuda and M <= 16:
        a = torch.cat([a, a.new_zeros(32 - M, a.shape[1])])
        return torch._int_mm(a, b)[:M]
    return torch._int_mm(a, b)


def _rms(x: torch.Tensor, norm_w: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return xf * torch.rsqrt(var + eps) * norm_w.float()


# --- fused QKV -----------------------------------------------------------------


def fused_qkv(x, norm_w, w_q, w_s, w_b, *, eps: float = 1e-6):
    """rms_norm + W8A8 quant + one [D, Q+2KV] int8 projection + bias.

    x [M, D] f32/bf16; norm_w [D]; w_q [D, N] int8; w_s, w_b [N] f32.
    Returns [M, N] in x's dtype: cast(acc * xs * ws) + cast(bias)."""
    if x.device.type == "cpu":
        return fused_qkv_plain(x, norm_w, w_q, w_s, w_b, eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"fused_qkv: unsupported device {x.device}")
    return _fused_qkv_cuda(x, norm_w, w_q, w_s, w_b, eps)


def fused_qkv_plain(x, norm_w, w_q, w_s, w_b, *, eps: float = 1e-6):
    xq, xs = quantize_act(_rms(x, norm_w, eps))
    acc = int8_matmul(xq, w_q)
    deq = (acc.float() * xs * w_s).to(x.dtype)
    return deq + w_b.to(x.dtype)


def _check_w8a8(name, x, D, pairs):
    if x.dim() != 2 or x.shape[1] != D:
        raise ValueError(f"{name}: x {tuple(x.shape)} vs weight rows {D}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: x must be f32 or bf16, got {x.dtype}")
    for w, s, n_out in pairs:
        if w.dtype != torch.int8 or s.dtype != torch.float32 or s.shape != (n_out,):
            raise TypeError(f"{name}: weights must be int8 with f32 [{n_out}] scales")
        if w.data_ptr() % 4 or w.shape[0] % 4:
            raise ValueError(f"{name}: weight rows must be 4-byte aligned")


def _fused_qkv_cuda(x, norm_w, w_q, w_s, w_b, eps):
    name = "fused_qkv"
    M, D = x.shape
    N = w_q.shape[1]
    nw = norm_w.float().contiguous()
    _build.check_inputs(name, x, nw, w_q, w_s, w_b)
    _check_w8a8(name, x, w_q.shape[0], [(w_q, w_s, N)])
    if w_b.dtype != torch.float32 or w_b.shape != (N,):
        raise TypeError(f"{name}: bias must be f32 [{N}]")
    xq = torch.empty(M, D, dtype=torch.int8, device=x.device)
    xs = torch.empty(M, dtype=torch.float32, device=x.device)
    out = torch.empty(M, N, dtype=x.dtype, device=x.device)
    fn = _build.bind("w8a8.cu", "neutts_fused_qkv", 8, 4, 1)
    with torch.cuda.device(x.device):
        rc = fn(
            x.data_ptr(), nw.data_ptr(), w_q.data_ptr(), w_s.data_ptr(), w_b.data_ptr(),
            xq.data_ptr(), xs.data_ptr(), out.data_ptr(), M, D, N, _build.DTYPE_CODE[x.dtype],
            float(eps), _build.stream_of(x.device),
        )
    _build.check(rc, name)
    _build.launches[name] += 1
    return out


# --- fused MLP -----------------------------------------------------------------


def fused_mlp(x, norm_w, wg_q, wg_s, wu_q, wu_s, wd_q, wd_s, *, eps: float = 1e-6):
    """x + down(silu(gate(h)) * up(h)), h = rms_norm(x), with W8A8 dots.

    x [M, D] f32/bf16; wg/wu [D, F] and wd [F, D] int8 with f32
    per-output-channel scales. Returns [M, D] in x's dtype. The CUDA kernel
    takes the weights K-major (`backbone.k_major`: the [K, N] weight as a
    view of [N, K] storage), the operand layout of its int8 tensor cores;
    the plain version takes either layout."""
    if x.device.type == "cpu":
        return fused_mlp_plain(x, norm_w, wg_q, wg_s, wu_q, wu_s, wd_q, wd_s, eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"fused_mlp: unsupported device {x.device}")
    return _fused_mlp_cuda(x, norm_w, wg_q, wg_s, wu_q, wu_s, wd_q, wd_s, eps)


def fused_mlp_plain(x, norm_w, wg_q, wg_s, wu_q, wu_s, wd_q, wd_s, *, eps: float = 1e-6):
    xq, xs = quantize_act(_rms(x, norm_w, eps))
    g = int8_matmul(xq, wg_q).float() * xs * wg_s
    u = int8_matmul(xq, wu_q).float() * xs * wu_s
    ffq, ffs = quantize_act(F.silu(g) * u)
    d = int8_matmul(ffq, wd_q).float() * ffs * wd_s
    return x + d.to(x.dtype)


def mlp_tile() -> dict:
    """The GEMM tiles of csrc/w8a8.cu's MLP kernels (needs the built
    library): token rows and gate/up columns per gate/up block, token rows
    and columns per down block, k bytes per stage, stages, threads."""
    import ctypes

    fn = _build.bind("w8a8.cu", "neutts_fused_mlp_tile", 0, 0)  # (int*)
    shape = (ctypes.c_int * 7)()
    _build.check(fn(ctypes.addressof(shape)), "mlp_tile")
    keys = ("gate_up_rows", "gate_up_cols", "down_rows", "down_cols", "k_bytes", "stages",
            "threads")
    return dict(zip(keys, shape))


def _fused_mlp_cuda(x, norm_w, wg_q, wg_s, wu_q, wu_s, wd_q, wd_s, eps):
    name = "fused_mlp"
    M, D = x.shape
    Fd = wg_q.shape[1]
    nw = norm_w.float().contiguous()
    if wu_q.shape != (D, Fd) or wd_q.shape != (Fd, D):
        raise ValueError(f"{name}: gate {tuple(wg_q.shape)}, up {tuple(wu_q.shape)}, "
                         f"down {tuple(wd_q.shape)}")
    for w in (wg_q, wu_q, wd_q):
        if not w.mT.is_contiguous():
            raise ValueError(f"{name}: weights must be K-major ([N, K] storage, "
                             f"backbone.k_major), got strides {w.stride()}")
        if w.data_ptr() % 16:
            raise ValueError(f"{name}: weights must be 16-byte aligned")
    # the K-major weights are contiguous as their transposes
    _build.check_inputs(name, x, nw, wg_q.mT, wg_s, wu_q.mT, wu_s, wd_q.mT, wd_s)
    _check_w8a8(name, x, wg_q.shape[0], [(wg_q, wg_s, Fd), (wu_q, wu_s, Fd), (wd_q, wd_s, D)])
    if D % 16 or Fd % 16:
        raise ValueError(f"{name}: D={D} and F={Fd} must be multiples of 16")
    dev = x.device
    xq = torch.empty(M, D, dtype=torch.int8, device=dev)
    xs = torch.empty(M, dtype=torch.float32, device=dev)
    ff = torch.empty(M, Fd, dtype=torch.float32, device=dev)
    amax = torch.empty(M, dtype=torch.int32, device=dev)  # f32 bits: zeroed, then atomicMax'd
    out = torch.empty_like(x)
    fn = _build.bind("w8a8.cu", "neutts_fused_mlp", 13, 4, 1)
    with torch.cuda.device(dev):
        rc = fn(
            x.data_ptr(), nw.data_ptr(), wg_q.data_ptr(), wg_s.data_ptr(), wu_q.data_ptr(),
            wu_s.data_ptr(), wd_q.data_ptr(), wd_s.data_ptr(), xq.data_ptr(), xs.data_ptr(),
            ff.data_ptr(), amax.data_ptr(), out.data_ptr(), M, D, Fd,
            _build.DTYPE_CODE[x.dtype], float(eps), _build.stream_of(dev),
        )
    _build.check(rc, name)
    _build.launches[name] += 1
    return out
