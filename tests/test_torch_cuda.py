"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: these need an NVIDIA GPU and nvcc and skip without them (the
CPU suite covers the plain versions against the JAX package). On the card:

    python -m pytest tests/test_torch_cuda.py -q

Small shapes with the path's head geometry; the Air-size comparison, timing
and end-to-end runs are in chip_smoke.py. Tolerances: f32 cases differ by
summation order only (1e-4); bf16 outputs by one bf16 rounding (2e-2); W8A8
by at most one int8 quantization step (2e-2, 3e-2 for the MLP's second
quantization, of the output range).
"""

import pytest
import torch

from neutts_tpu_torch.models import backbone as bb
from neutts_tpu_torch.ops import _build
from neutts_tpu_torch.ops import attention as attn
from neutts_tpu_torch.ops import mlp as mlp_ops

pytestmark = pytest.mark.cuda


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _randn(dev, *shape, dtype=torch.float32, seed=0, scale=1.0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)


@pytest.mark.parametrize("dtype,mode,G,D", [
    (torch.float32, "float", 7, 64), (torch.bfloat16, "float", 7, 64),
    (torch.bfloat16, "int8", 7, 64), (torch.float32, "int8", 2, 16),
])
def test_decode_attention_kernel(dev, dtype, mode, G, D):
    L, B, K, T = 3, 4, 2, 300
    q = _randn(dev, B, K, G, D, dtype=dtype)
    ck = _randn(dev, L, B, T, K * D, dtype=dtype, seed=1)
    cv = _randn(dev, L, B, T, K * D, dtype=dtype, seed=2)
    ks = vs = None
    if mode == "int8":
        (ck, ks), (cv, vs) = bb.quantize_kv(ck), bb.quantize_kv(cv)
    lens = torch.tensor([300, 65, 1, 200], dtype=torch.int32, device=dev)
    pad = torch.tensor([0, 64, 0, 17], dtype=torch.int32, device=dev)
    before = _build.launches[f"decode_attention_{'int8' if mode == 'int8' else 'bf16'}"]
    got = attn.decode_attention(q, ck, cv, 1, lens, pad, ks, vs)
    torch.cuda.synchronize()
    want = attn.decode_attention_plain(q, ck, cv, 1, lens, pad, ks, vs)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    assert _build.launches[f"decode_attention_{'int8' if mode == 'int8' else 'bf16'}"] == before + 1


@pytest.mark.parametrize("dtype,S,G,D", [
    (torch.float32, 128, 7, 64), (torch.bfloat16, 192, 7, 64), (torch.float32, 48, 2, 16),
])
def test_prefill_attention_kernel(dev, dtype, S, G, D):
    B, K = 4, 2
    q = _randn(dev, B, S, K * G, D, dtype=dtype)
    k = _randn(dev, B, S, K, D, dtype=dtype, seed=1)
    v = _randn(dev, B, S, K, D, dtype=dtype, seed=2)
    pads = torch.tensor([0, 3, S // 2, S - 1], dtype=torch.int32, device=dev)
    got = attn.prefill_attention(q, k, v, pads)
    torch.cuda.synchronize()
    want = attn.prefill_attention_plain(q, k, v, pads)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_w8a8_kernels(dev, dtype):
    M, D, N, F = 200, 128, 192, 320  # M not a multiple of the 64-row tile
    x = _randn(dev, M, D, dtype=dtype, scale=0.5)
    nw = 1.0 + 0.1 * _randn(dev, D, seed=1)
    w = bb.quantize_weight(_randn(dev, D, N, seed=2, scale=D**-0.5))
    b = _randn(dev, N, seed=3, scale=0.05)
    got = mlp_ops.fused_qkv(x, nw, w["q"], w["s"], b)
    want = mlp_ops.fused_qkv_plain(x, nw, w["q"], w["s"], b)
    assert float((got.float() - want.float()).abs().max()) <= 2e-2 * float(want.abs().max())
    wg, wu = (bb.quantize_weight(_randn(dev, D, F, seed=s, scale=D**-0.5)) for s in (4, 5))
    wd = bb.quantize_weight(_randn(dev, F, D, seed=6, scale=F**-0.5))
    args = (x, nw, wg["q"], wg["s"], wu["q"], wu["s"], wd["q"], wd["s"])
    got = mlp_ops.fused_mlp(*args)
    want = mlp_ops.fused_mlp_plain(*args)
    assert float((got.float() - want.float()).abs().max()) <= 3e-2 * float(want.abs().max())


def test_wrappers_raise_on_bad_inputs(dev):
    q = _randn(dev, 2, 2, 7, 64, dtype=torch.bfloat16)
    ck = _randn(dev, 1, 2, 16, 128, dtype=torch.float32)  # dtype differs from q
    lens = torch.full((2,), 16, dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):
        attn.decode_attention(q, ck, ck, 0, lens, lens * 0)
    with pytest.raises(TypeError):
        attn.decode_attention(q, ck.bfloat16(), ck.bfloat16(), 0, lens.long(), lens * 0)


def test_int_mm_row_padding(dev):
    """Why `int8_matmul` pads: `torch._int_mm` on CUDA refuses M <= 16 (decode
    runs M = batch); the padded call is exact."""
    g = torch.Generator(device=dev).manual_seed(7)
    a = torch.randint(-127, 128, (8, 896), generator=g, device=dev, dtype=torch.int8)
    b = torch.randint(-127, 128, (896, 128), generator=g, device=dev, dtype=torch.int8)
    with pytest.raises(RuntimeError):
        torch._int_mm(a, b)
    want = (a.double() @ b.double()).to(torch.int32)
    torch.testing.assert_close(mlp_ops.int8_matmul(a, b), want, rtol=0, atol=0)
