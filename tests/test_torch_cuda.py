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

import _torch_threads  # noqa: F401  (pins torch's threads in this process)

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
    # the main paths' buckets and a length off the 64-key tile, both modes
    *((dt, S, G, D) for dt, G, D in ((torch.bfloat16, 7, 64), (torch.float32, 2, 16))
      for S in (48, 320, 384, 512)),
    # other GQA groups of the tensor-core kernel: two 16-row slices per head
    # in a block (4), heads split over two blocks (12)
    (torch.bfloat16, 200, 4, 64), (torch.bfloat16, 200, 12, 64),
])
def test_prefill_attention_kernel(dev, dtype, S, G, D):
    """Pads 0, 3, S/2, S - 1 (one live row) and S (an all-pad row: zeros)."""
    B, K = 5, 2
    q = _randn(dev, B, S, K * G, D, dtype=dtype)
    k = _randn(dev, B, S, K, D, dtype=dtype, seed=1)
    v = _randn(dev, B, S, K, D, dtype=dtype, seed=2)
    pads = torch.tensor([0, 3, S // 2, S - 1, S], dtype=torch.int32, device=dev)
    before = _build.launches["prefill_attention"]
    got = attn.prefill_attention(q, k, v, pads)
    torch.cuda.synchronize()
    want = attn.prefill_attention_plain(q, k, v, pads)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    assert not got[4].any() and not got[3, : S - 1].any()
    assert _build.launches["prefill_attention"] == before + 1


def _decode_inputs(dev, mode, B, T, lens, pad, G=7, D=64, L=2, K=2):
    """q [B, K, G, D] bf16 and a bf16, int8 or int4 cache of L layers."""
    q = _randn(dev, B, K, G, D, dtype=torch.bfloat16)
    ks = vs = None
    if mode == "int4":
        (ck, ks), (cv, vs) = _int4(dev, L, B, T, K * D, 1), _int4(dev, L, B, T, K * D, 2)
    else:
        ck = _randn(dev, L, B, T, K * D, dtype=torch.bfloat16, seed=1)
        cv = _randn(dev, L, B, T, K * D, dtype=torch.bfloat16, seed=2)
        if mode == "int8":
            (ck, ks), (cv, vs) = bb.quantize_kv(ck), bb.quantize_kv(cv)
    lens = torch.tensor(lens, dtype=torch.int32, device=dev)
    pad = torch.tensor(pad, dtype=torch.int32, device=dev)
    return q, ck, cv, 1, lens, pad, ks, vs


@pytest.mark.parametrize("T,lens,pad", [
    # an empty row (lens == pad: the kernel writes zeros where the plain
    # softmax spreads over masked slots), a row shorter than one chunk, odd
    # pads and lens (int4: half-byte masks at chunk edges), full rows
    (1024, [700, 37, 129, 1023, 641, 1024], [700, 30, 65, 1, 63, 127]),
    (2048, [1903], [5]),  # the bf16 `infer` shape: one long row, the most splits
    (64, [64, 33, 7], [0, 3, 7]),  # one tile: NSPLIT 1, a block merges its own partial
])
@pytest.mark.parametrize("mode", ["bf16", "int8", "int4"])
def test_decode_attention_split_ranges(dev, mode, T, lens, pad):
    args = _decode_inputs(dev, mode, len(lens), T, lens, pad)
    assert (attn.decode_splits(len(lens), 2, T, dev) == 1) == (T <= 64)
    got = attn.decode_attention(*args)
    torch.cuda.synchronize()
    want = attn.decode_attention_plain(*args)
    live = args[4] > args[5]  # lens > pad
    assert not got[~live].any()
    # each row within 1% of its largest |output|: a chunk dropped or merged
    # with the wrong weight moves a row past it
    got, want = got[live].float(), want[live].float()
    row_tol = 1e-2 * want.abs().amax(dim=(1, 2, 3), keepdim=True)
    assert bool(((got - want).abs() <= row_tol).all()), float((got - want).abs().max())


@pytest.mark.parametrize("mode", ["bf16", "int8", "int4"])
def test_decode_attention_is_deterministic(dev, mode):
    """200 calls on the same inputs give bit-equal outputs: the merge runs in
    a fixed order and every launch leaves its counters at 0."""
    B, T = 8, 1024
    args = _decode_inputs(dev, mode, B, T, [1000, 1024, 800, 961, 1024, 700, 1010, 901],
                          [0, 5, 13, 64, 1, 100, 7, 31])
    first = attn.decode_attention(*args)
    outs = [attn.decode_attention(*args) for _ in range(200)]
    torch.cuda.synchronize()
    assert all(torch.equal(o, first) for o in outs)


def test_decode_attention_is_one_kernel(dev):
    """One call is one CUDA kernel: no second launch for the merge, no
    memset, and no host synchronisation."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    args = _decode_inputs(dev, "int8", 8, 1024, [1000] * 8, [3] * 8)
    attn.decode_attention(*args)  # builds the kernel and the split workspace
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            attn.decode_attention(*args)
            torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    on_device = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    assert len(on_device) == 1 and "decode_attention_kernel" in on_device[0], on_device


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_w8a8_kernels(dev, dtype):
    M, D, N, F = 200, 128, 192, 320  # M not a multiple of the 64-row tile
    x = _randn(dev, M, D, dtype=dtype, scale=0.5)
    nw = 1.0 + 0.1 * _randn(dev, D, seed=1)
    w, b = _qkv_weight(dev, D, N)
    got = mlp_ops.fused_qkv(x, nw, *w, b)
    want = mlp_ops.fused_qkv_plain(x, nw, *w, b)
    assert float((got.float() - want.float()).abs().max()) <= 2e-2 * float(want.abs().max())
    args = (x, nw, *_mlp_weights(dev, D, F))
    got = mlp_ops.fused_mlp(*args)
    want = mlp_ops.fused_mlp_plain(*args)
    assert float((got.float() - want.float()).abs().max()) <= 3e-2 * float(want.abs().max())


def _qkv_weight(dev, D, N):
    """The fused [D, N] int8 weight (K-major, as backbone.quantize_params
    stores it) with its scales, and an f32 bias."""
    w = bb.quantize_weight(_randn(dev, D, N, seed=2, scale=D**-0.5))
    return (bb.k_major(w["q"]), w["s"]), _randn(dev, N, seed=3, scale=0.05)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D,N", [(64, 128), (512, 768), (896, 1152)])  # TINY, Nano, Air
@pytest.mark.parametrize("M", [200, 2112, 4096, 16400])
def test_fused_qkv_tensor_core_kernel(dev, M, D, N, dtype):
    """The int8 tensor-core QKV at the three model widths, token counts off
    and on the 64-row tile and, at M 16400, on the 128-row tile it takes
    from w8a8_tiles()["qkv_wide_m"] rows, against the plain version within
    one quantization step: 2e-2 of the output's range; one launch per call."""
    if M == 16400:
        assert M >= mlp_ops.w8a8_tiles()["qkv_wide_m"]
    x = _randn(dev, M, D, dtype=dtype, scale=0.5)
    nw = 1.0 + 0.1 * _randn(dev, D, seed=1)
    w, b = _qkv_weight(dev, D, N)
    before = _build.launches["fused_qkv"]
    got = mlp_ops.fused_qkv(x, nw, *w, b)
    torch.cuda.synchronize()
    assert _build.launches["fused_qkv"] == before + 1
    want = mlp_ops.fused_qkv_plain(x, nw, *w, b)
    assert got.dtype == dtype and got.shape == (M, N) and torch.isfinite(got.float()).all()
    assert float((got.float() - want.float()).abs().max()) <= 2e-2 * float(want.abs().max())


def test_fused_qkv_raises_on_row_major_weight(dev):
    """The kernel takes a K-major weight only; a row-major one raises (no
    fallback to the plain version), and so does a width off the 16 grid."""
    x = _randn(dev, 64, 128, scale=0.5)
    (wq, ws), b = _qkv_weight(dev, 128, 192)
    before = _build.launches["fused_qkv"]
    with pytest.raises(ValueError):
        mlp_ops.fused_qkv(x, torch.ones(128, device=dev), wq.contiguous(), ws, b)
    (wq, ws), b = _qkv_weight(dev, 128, 200)
    with pytest.raises(ValueError):
        mlp_ops.fused_qkv(x, torch.ones(128, device=dev), wq, ws, b)
    assert _build.launches["fused_qkv"] == before


def _mlp_weights(dev, D, F):
    """Quantized gate, up (K-major [D, F]) and down (K-major [F, D]) weights
    with their scales, as backbone.quantize_params stores them."""
    ws = [bb.quantize_weight(_randn(dev, D, F, seed=s, scale=D**-0.5)) for s in (4, 5)]
    ws.append(bb.quantize_weight(_randn(dev, F, D, seed=6, scale=F**-0.5)))
    return [t for w in ws for t in (bb.k_major(w["q"]), w["s"])]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D,F", [(64, 128), (512, 2816), (896, 4864)])  # TINY, Nano, Air
@pytest.mark.parametrize("M", [200, 2112, 4096])
def test_fused_mlp_tensor_core_kernel(dev, M, D, F, dtype):
    """The int8 tensor-core MLP at the three model widths, token counts off
    and on the 128- and 64-row tiles (admission groups are rows x 512, with
    any number of rows), against the plain version within one quantization
    step through the ff quantization: 3e-2 of the output's range."""
    x = _randn(dev, M, D, dtype=dtype, scale=0.5)
    nw = 1.0 + 0.1 * _randn(dev, D, seed=1)
    args = (x, nw, *_mlp_weights(dev, D, F))
    before = _build.launches["fused_mlp"]
    got = mlp_ops.fused_mlp(*args)
    torch.cuda.synchronize()
    assert _build.launches["fused_mlp"] == before + 1
    want = mlp_ops.fused_mlp_plain(*args)
    assert got.dtype == dtype and torch.isfinite(got.float()).all()
    assert float((got.float() - want.float()).abs().max()) <= 3e-2 * float(want.abs().max())


def test_fused_mlp_raises_on_row_major_weights(dev):
    """The kernel takes K-major weights only; a row-major one raises (no
    fallback to the plain version)."""
    x = _randn(dev, 64, 128, scale=0.5)
    args = list(_mlp_weights(dev, 128, 256))
    args[0] = args[0].contiguous()  # gate [D, F] row-major
    with pytest.raises(ValueError):
        mlp_ops.fused_mlp(x, torch.ones(128, device=dev), *args)


def test_int_mm_takes_k_major_weight_without_copy(dev):
    """`torch._int_mm` accepts the K-major view of a weight (decode's `_mm`
    with the MLP weights), exactly and with no copy of the weight: one
    kernel on the device, no copy kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    g = torch.Generator(device=dev).manual_seed(9)
    a = torch.randint(-127, 128, (32, 896), generator=g, device=dev, dtype=torch.int8)
    w = bb.k_major(torch.randint(-127, 128, (896, 4864), generator=g, device=dev,
                                 dtype=torch.int8))
    assert w.mT.is_contiguous()
    want = (a.double() @ w.double()).to(torch.int32)
    torch.testing.assert_close(torch._int_mm(a, w), want, rtol=0, atol=0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch._int_mm(a, w)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()]
    assert not any(n in ("aten::copy_", "aten::clone", "aten::contiguous") for n in names), names
    on_device = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    assert len(on_device) == 1, on_device


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


# --- serving kernels (staged decode, reconcile, admission write) -------------------


def _staging(dev, L, B, S, KD, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    sk = torch.randint(-127, 128, (L, B, S, KD), generator=g, device=dev, dtype=torch.int8)
    sv = torch.randint(-127, 128, (L, B, S, KD), generator=g, device=dev, dtype=torch.int8)
    sks = torch.rand((L, B, attn.SEG_PAD), generator=g, device=dev) * 0.1 + 0.01
    svs = torch.rand((L, B, attn.SEG_PAD), generator=g, device=dev) * 0.1 + 0.01
    return sk, sv, sks, svs


@pytest.mark.parametrize("dtype,G,D,step", [
    (torch.bfloat16, 7, 64, 0), (torch.bfloat16, 7, 64, 31), (torch.float32, 2, 16, 17),
])
def test_staged_attention_kernel(dev, dtype, G, D, step):
    """Ragged settled lengths, a row with base == 0 (staging only) and one
    whose settled range crosses several 64-token tiles."""
    L, B, K, T, S = 2, 4, 2, 320, 32
    q = _randn(dev, B, K, G, D, dtype=dtype)
    (ck, ks), (cv, vs) = (bb.quantize_kv(_randn(dev, L, B, T, K * D, seed=s)) for s in (1, 2))
    stag = _staging(dev, L, B, S, K * D, seed=3)
    base = torch.tensor([0, 64, 320, 130], dtype=torch.int32, device=dev)
    pad = torch.tensor([0, 5, 0, 64], dtype=torch.int32, device=dev)
    args = (q, ck, cv, ks, vs, *stag, 1, step, base, pad)
    before = _build.launches["decode_attention_staged"]
    got = attn.decode_attention_staged(*args)
    torch.cuda.synchronize()
    want = attn.decode_attention_staged_plain(*args)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    assert _build.launches["decode_attention_staged"] == before + 1


def _staged_inputs(dev, mode, B, base, pad, L=2, K=2, G=7, D=64, S=32, seed=10):
    """q, an int8 [L, B, T, K*D] or packed int4 cache at the serving slot
    lengths (T 2304 / 2560) and int8 staging, unit-normal values."""
    T = 2304 if mode == "int8" else 2560
    q = _randn(dev, B, K, G, D, dtype=torch.bfloat16, seed=seed)
    if mode == "int4":
        (ck, ks), (cv, vs) = _int4(dev, L, B, T, K * D, 1), _int4(dev, L, B, T, K * D, 2)
        sq = [bb.quantize_kv4(_randn(dev, L, B, S, K * D, seed=s)) for s in (3, 4)]
    else:
        (ck, ks), (cv, vs) = (bb.quantize_kv(_randn(dev, L, B, T, K * D, seed=s)) for s in (1, 2))
        sq = [bb.quantize_kv(_randn(dev, L, B, S, K * D, seed=s)) for s in (3, 4)]
    stag = (sq[0][0], sq[1][0], torch.nn.functional.pad(sq[0][1], (0, attn.SEG_PAD - S)),
            torch.nn.functional.pad(sq[1][1], (0, attn.SEG_PAD - S)))
    base = torch.tensor(base, dtype=torch.int32, device=dev)
    pad = torch.tensor(pad, dtype=torch.int32, device=dev)
    return q, ck, cv, ks, vs, *stag, base, pad


def _staged_rows(B, seed=0):
    """Settled lengths of B serving rows (even; rows 1, 9, 17, ... empty:
    base == 0) and pads (odd ones among them)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    base = rng.integers(1, 1025, B) * 2
    base[1::8] = 0
    pad = np.minimum(base, rng.integers(0, 200, B))
    return base.tolist(), pad.tolist()


@pytest.mark.parametrize("step", [0, 17, 31])
@pytest.mark.parametrize("B", [1, 16, 128])
@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_staged_attention_split_ranges(dev, mode, B, step):
    """The split-K staged kernel at the serving geometry (G 7, D 64, T of the
    slot cache, S 32): NSPLIT + 1 partials from B * K, rows with base == 0
    (staging alone), odd pads. Each row within 1% of its largest |output|."""
    base, pad = _staged_rows(B)
    x = _staged_inputs(dev, mode, B, base, pad)
    args = (*x[:9], 1, step, *x[9:])
    key = "decode_attention_staged" + ("_int4" if mode == "int4" else "")
    before = _build.launches[key]
    got = attn.decode_attention_staged(*args)
    torch.cuda.synchronize()
    assert _build.launches[key] == before + 1
    want = attn.decode_attention_staged_plain(*args).float()
    got = got.float()
    assert torch.isfinite(got).all()
    row_tol = 1e-2 * want.abs().amax(dim=(1, 2, 3), keepdim=True)
    assert bool(((got - want).abs() <= row_tol).all()), float((got - want).abs().max())


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_staged_attention_is_deterministic(dev, mode):
    """200 calls at the serving shape (B 128) give bit-equal outputs."""
    base, pad = _staged_rows(128)
    x = _staged_inputs(dev, mode, 128, base, pad)
    args = (*x[:9], 1, 17, *x[9:])
    first = attn.decode_attention_staged(*args)
    outs = [attn.decode_attention_staged(*args) for _ in range(200)]
    torch.cuda.synchronize()
    assert all(torch.equal(o, first) for o in outs)


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_staged_attention_is_one_kernel(dev, mode):
    """One staged call is one CUDA kernel (the staging chunk and the merge
    in the same launch, no memset) and makes no host synchronisation."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    base, pad = _staged_rows(128)
    x = _staged_inputs(dev, mode, 128, base, pad)
    args = (*x[:9], 1, 17, *x[9:])
    attn.decode_attention_staged(*args)  # builds the kernel and the split workspace
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            attn.decode_attention_staged(*args)
            torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    on_device = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    assert len(on_device) == 1 and "staged_attention_kernel" in on_device[0], on_device


def test_decode_and_staged_share_a_workspace(dev):
    """Kernels #1 and #2 at one workspace key (B 4, K 2, G 7, D 64 and three
    partials: #1 NSPLIT 3 over T 192, #2 NSPLIT 2 + staging over T 128),
    called in turns: every output right and bit-equal to its first, so
    each launch leaves the shared counters at 0 for the next."""
    B, K = 4, 2
    assert attn.decode_splits(B, K, 192, dev) == 3 and attn.decode_splits(B, K, 128, dev) == 2
    d_args = _decode_inputs(dev, "int8", B, 192, [192, 100, 7, 150], [0, 3, 0, 64])
    base, pad = [128, 0, 64, 100], [0, 0, 3, 33]
    x = _staged_inputs(dev, "int8", B, base, pad)
    # the staged inputs at T 128: the first 128 slots of the slot cache
    s_args = (x[0], x[1][:, :, :128].contiguous(), x[2][:, :, :128].contiguous(),
              x[3][:, :, :128].contiguous(), x[4][:, :, :128].contiguous(), *x[5:9], 1, 9,
              *x[9:])
    n_ws = len(attn._split_ws)
    firsts = attn.decode_attention(*d_args), attn.decode_attention_staged(*s_args)
    assert len(attn._split_ws) <= n_ws + 1  # one key for both
    for _ in range(50):
        got = attn.decode_attention(*d_args), attn.decode_attention_staged(*s_args)
        torch.cuda.synchronize()
        assert torch.equal(got[0], firsts[0]) and torch.equal(got[1], firsts[1])
    for got, want in ((firsts[0], attn.decode_attention_plain(*d_args)),
                      (firsts[1], attn.decode_attention_staged_plain(*s_args))):
        got, want = got.float(), want.float()
        row_tol = 1e-2 * want.abs().amax(dim=(1, 2, 3), keepdim=True)
        assert bool(((got - want).abs() <= row_tol).all()), float((got - want).abs().max())


def test_reconcile_kernel_exact(dev):
    """Active rows land at [base, base + S), an inactive row and the rows'
    other slots stay untouched; a row at the end of the cache fits exactly."""
    L, B, T, KD, S = 3, 5, 256, 128, 32
    g = torch.Generator(device=dev).manual_seed(4)
    bufs = [torch.randint(-127, 128, (L, B, T, KD), generator=g, device=dev, dtype=torch.int8)
            for _ in range(2)]
    bufs += [torch.rand((L, B, T), generator=g, device=dev) for _ in range(2)]
    stag = _staging(dev, L, B, S, KD, seed=5)
    base = torch.tensor([0, 64, 224, 128, 8], dtype=torch.int32, device=dev)
    active = torch.tensor([True, False, True, True, True], device=dev)
    got = attn.reconcile_segment(*(b.clone() for b in bufs), *stag, base, active)
    torch.cuda.synchronize()
    want = attn.reconcile_segment_plain(*(b.clone() for b in bufs), *stag, base, active)
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    assert torch.equal(got[0][:, 1], bufs[0][:, 1])


@pytest.mark.parametrize("active_rows", ["half", "none"])
@pytest.mark.parametrize("int4", [False, True])
def test_reconcile_air_serving_shape_exact(dev, int4, active_rows):
    """Both reconcile modes at the Air serving shape (L 24, B 128, S 32,
    K*D 128; T 2304 int8, 2560 int4): about half the rows active with one
    ending exactly at T, or none; the cache equals the plain version's byte
    for byte and inactive rows are untouched."""
    L, B, S, KD = 24, 128, 32, 128
    T = 2560 if int4 else 2304
    g = torch.Generator(device=dev).manual_seed(12)
    shape = (L, B, T // 2 if int4 else T, KD)
    bufs = [torch.randint(-119, 120, shape, generator=g, device=dev, dtype=torch.int8)
            for _ in range(2)]
    bufs += [torch.rand((L, B, T), generator=g, device=dev) for _ in range(2)]
    lo = 7 if int4 else 127
    stag = [torch.randint(-lo, lo + 1, (L, B, S, KD), generator=g, device=dev,
                          dtype=torch.int8) for _ in range(2)]
    stag += [torch.rand((L, B, attn.SEG_PAD), generator=g, device=dev) for _ in range(2)]
    base = torch.randint(0, (T - S) // 16 + 1, (B,), generator=g, device=dev,
                         dtype=torch.int32) * 16
    base[3] = T - S
    if active_rows == "half":
        active = torch.rand(B, generator=g, device=dev) < 0.5
        active[3] = True
    else:
        active = torch.zeros(B, dtype=torch.bool, device=dev)
    fn, plain = ((attn.reconcile_segment4, attn.reconcile_segment4_plain) if int4 else
                 (attn.reconcile_segment, attn.reconcile_segment_plain))
    got = fn(*(t.clone() for t in bufs), *stag, base, active)
    torch.cuda.synchronize()
    want = plain(*(t.clone() for t in bufs), *stag, base, active)
    for x, y, before in zip(got, want, bufs):
        assert torch.equal(x, y)
        assert torch.equal(x[:, ~active], before[:, ~active])


def test_scatter_prefill_kernel_exact(dev):
    """Duplicate slots written once, rows not named untouched."""
    L, B, T, KD, G, Lp = 3, 6, 256, 128, 4, 192
    g = torch.Generator(device=dev).manual_seed(6)
    bufs = [torch.randint(-127, 128, (L, B, T, KD), generator=g, device=dev, dtype=torch.int8)
            for _ in range(2)]
    bufs += [torch.rand((L, B, T), generator=g, device=dev) for _ in range(2)]
    new = [torch.randint(-127, 128, (L, G, Lp, KD), generator=g, device=dev, dtype=torch.int8)
           for _ in range(2)]
    new += [torch.rand((L, G, Lp), generator=g, device=dev) for _ in range(2)]
    for a in new:
        a[:, 3] = a[:, 1]
    slots = torch.tensor([5, 2, 0, 2], dtype=torch.int32, device=dev)
    primary = torch.tensor([True, True, True, False], device=dev)
    got = attn.scatter_prefill(*(b.clone() for b in bufs), *new, slots, primary)
    torch.cuda.synchronize()
    want = attn.scatter_prefill_plain(*(b.clone() for b in bufs), *new, slots, primary)
    for x, y, before in zip(got, want, bufs):
        assert torch.equal(x, y)
        assert torch.equal(x[:, 1], before[:, 1]) and torch.equal(x[:, 3:5], before[:, 3:5])


# --- int4 modes (odd pads, odd lens, an empty row) ---------------------------------


def _int4(dev, L, B, T, KD, seed):
    """Packed int4 values [L, B, T/2, KD] and deinterleaved scales [L, B, T]
    of unit-normal K/V rows."""
    q, sc = bb.quantize_kv4(_randn(dev, L, B, T, KD, seed=seed))
    return bb.pack4_pairs(q).contiguous(), bb.scales4_block(sc).contiguous()


@pytest.mark.parametrize("dtype,G,D", [(torch.bfloat16, 7, 64), (torch.float32, 2, 16)])
def test_decode_attention_int4_kernel(dev, dtype, G, D):
    L, B, K, T = 3, 4, 2, 320
    q = _randn(dev, B, K, G, D, dtype=dtype)
    (kp, ks), (vp, vs) = _int4(dev, L, B, T, K * D, 1), _int4(dev, L, B, T, K * D, 2)
    lens = torch.tensor([301, 66, 1, 200], dtype=torch.int32, device=dev)
    pad = torch.tensor([0, 65, 0, 17], dtype=torch.int32, device=dev)
    before = _build.launches["decode_attention_int4"]
    got = attn.decode_attention(q, kp, vp, 1, lens, pad, ks, vs)
    torch.cuda.synchronize()
    want = attn.decode_attention_plain(q, kp, vp, 1, lens, pad, ks, vs)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    assert _build.launches["decode_attention_int4"] == before + 1


@pytest.mark.parametrize("dtype,G,D,step", [(torch.bfloat16, 7, 64, 17), (torch.float32, 2, 16, 0)])
def test_staged_attention_int4_kernel(dev, dtype, G, D, step):
    """Even bases (one row empty: staging alone), odd pads."""
    L, B, K, T, S = 2, 4, 2, 320, 32
    q = _randn(dev, B, K, G, D, dtype=dtype)
    (kp, ks), (vp, vs) = _int4(dev, L, B, T, K * D, 1), _int4(dev, L, B, T, K * D, 2)
    sq = [bb.quantize_kv4(_randn(dev, L, B, S, K * D, seed=s)) for s in (3, 4)]
    stag = (sq[0][0], sq[1][0], torch.nn.functional.pad(sq[0][1], (0, attn.SEG_PAD - S)),
            torch.nn.functional.pad(sq[1][1], (0, attn.SEG_PAD - S)))
    base = torch.tensor([0, 64, 320, 130], dtype=torch.int32, device=dev)
    pad = torch.tensor([0, 5, 1, 63], dtype=torch.int32, device=dev)
    args = (q, kp, vp, ks, vs, *stag, 1, step, base, pad)
    before = _build.launches["decode_attention_staged_int4"]
    got = attn.decode_attention_staged(*args)
    torch.cuda.synchronize()
    want = attn.decode_attention_staged_plain(*args)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    assert _build.launches["decode_attention_staged_int4"] == before + 1


def test_reconcile4_kernel_exact(dev):
    """Packed pairs at byte rows [base/2, base/2 + S/2), scales at their
    deinterleaved columns; the inactive row untouched; the last row ends at T."""
    L, B, T, KD, S = 3, 5, 512, 128, 32
    g = torch.Generator(device=dev).manual_seed(4)
    bufs = [torch.randint(-119, 120, (L, B, T // 2, KD), generator=g, device=dev,
                          dtype=torch.int8) for _ in range(2)]
    bufs += [torch.rand((L, B, T), generator=g, device=dev) for _ in range(2)]
    stag = [torch.randint(-7, 8, (L, B, S, KD), generator=g, device=dev, dtype=torch.int8)
            for _ in range(2)]
    stag += [torch.rand((L, B, attn.SEG_PAD), generator=g, device=dev) for _ in range(2)]
    base = torch.tensor([0, 64, T - S, 128, 16], dtype=torch.int32, device=dev)
    active = torch.tensor([True, False, True, True, True], device=dev)
    got = attn.reconcile_segment4(*(b.clone() for b in bufs), *stag, base, active)
    torch.cuda.synchronize()
    want = attn.reconcile_segment4_plain(*(b.clone() for b in bufs), *stag, base, active)
    for x, y, before in zip(got, want, bufs):
        assert torch.equal(x, y)
        assert torch.equal(x[:, 1], before[:, 1])


def test_scatter_prefill4_kernel_exact(dev):
    """Duplicate slots written once, rows not named untouched."""
    L, B, T, KD, G, Lp = 3, 6, 512, 128, 4, 192
    g = torch.Generator(device=dev).manual_seed(6)
    bufs = [torch.randint(-119, 120, (L, B, T // 2, KD), generator=g, device=dev,
                          dtype=torch.int8) for _ in range(2)]
    bufs += [torch.rand((L, B, T), generator=g, device=dev) for _ in range(2)]
    new = [torch.randint(-119, 120, (L, G, Lp // 2, KD), generator=g, device=dev,
                         dtype=torch.int8) for _ in range(2)]
    new += [torch.rand((L, G, Lp), generator=g, device=dev) for _ in range(2)]
    for a in new:
        a[:, 3] = a[:, 1]
    slots = torch.tensor([5, 2, 0, 2], dtype=torch.int32, device=dev)
    primary = torch.tensor([True, True, True, False], device=dev)
    got = attn.scatter_prefill4(*(b.clone() for b in bufs), *new, slots, primary)
    torch.cuda.synchronize()
    want = attn.scatter_prefill4_plain(*(b.clone() for b in bufs), *new, slots, primary)
    for x, y, before in zip(got, want, bufs):
        assert torch.equal(x, y)
        assert torch.equal(x[:, 1], before[:, 1]) and torch.equal(x[:, 3:5], before[:, 3:5])


@pytest.mark.parametrize("kv_dtype", ["float32", "int8", "int4"])
def test_tiny_engine_gpu_matches_cpu(dev, kv_dtype):
    """A small f32 Engine on the card (kernels) emits the greedy tokens of
    the same Engine on the CPU (plain versions)."""
    from neutts_tpu_torch import config
    from neutts_tpu_torch.serving import Engine

    cfg = config.TINY.scaled(kv_dtype=kv_dtype)
    eos = cfg.layout.speech_gen_end
    params = bb.init_params(cfg, seed=3, device="cpu")
    scfg = config.SamplingConfig(greedy=True, min_new_tokens=2)
    prompts = [[3, 1, 4, 1, 5], [9, 2, 6], [2, 7, 1, 8, 2, 8], [11, 12]]
    results = []
    for d in ("cpu", dev):
        eng = Engine(cfg, params, eos_id=eos, n_slots=2, sampling=scfg, segment_steps=8,
                     device=d)  # int4 rounds the segment up to 16 steps
        rids = [eng.submit(p, max_new=24) for p in prompts]
        out = eng.run()
        results.append([out[r] for r in rids])
    assert results[0] == results[1]


@pytest.mark.parametrize("quantize,kv_dtype", [(False, "int8"), (True, "int8"), (True, "int4")])
def test_engine_dispatch_never_waits_for_the_device(dev, quantize, kv_dtype):
    """A dispatch (admission group + one staged int8 or int4 segment) queues
    its work without one host synchronisation, so the pipelined run overlaps
    the host's bookkeeping with the device; the readback then delivers."""
    from neutts_tpu_torch import config
    from neutts_tpu_torch.serving import Engine

    cfg = config.TINY.scaled(kv_dtype=kv_dtype)
    lay = cfg.layout
    params = bb.init_params(cfg, seed=3, device=dev)
    if quantize:
        params = bb.quantize_params(params)
    eng = Engine(cfg, params, eos_id=lay.speech_gen_end, n_slots=4,
                 sampling=config.SamplingConfig(min_new_tokens=16).constrained_to(lay),
                 segment_steps=16, device=dev)
    rids = [eng.submit([3 + i, 1, 4, 1, 5], max_new=16) for i in range(3)]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pending = eng.step_dispatch()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    eng.step_collect(pending)
    done = {r.rid: r.tokens for r in eng.pop_finished()}
    assert sorted(done) == rids and all(len(t) == 16 for t in done.values())


def test_traced_dispatch_never_waits_and_shares_the_profilers_clock(dev):
    """With the tracer on, a dispatch still makes no host synchronisation;
    under torch.profiler (the device alone) each kernel of a synchronised
    span runs between the span's start and end on the tracer's clock."""
    from torch.profiler import ProfilerActivity, profile

    from neutts_tpu_torch import config
    from neutts_tpu_torch.serving import Engine
    from neutts_tpu_torch.utils import TRACER, span

    cfg = config.TINY.scaled(kv_dtype="int8")
    lay = cfg.layout
    eng = Engine(cfg, bb.init_params(cfg, seed=3, device=dev), eos_id=lay.speech_gen_end,
                 n_slots=4, sampling=config.SamplingConfig(min_new_tokens=16).constrained_to(lay),
                 segment_steps=16, device=dev)
    rids = [eng.submit([3 + i, 1, 4, 1, 5], max_new=16) for i in range(3)]
    torch.cuda.synchronize()
    with TRACER.on() as records:
        torch.cuda.set_sync_debug_mode("error")
        try:
            pending = eng.step_dispatch()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        eng.step_collect(pending)
        a = torch.ones(1024, 1024, device=dev)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            with span("mm") as sp:
                a @ a
                torch.cuda.synchronize()
    assert sorted(r.rid for r in eng.pop_finished()) == rids
    assert {"engine.dispatch", "decode.step", "readback.wait"} <= {r.name for r in records}
    cuda = torch.autograd.DeviceType.CUDA
    ev = [e for e in prof.profiler.kineto_results.events() if e.device_type() == cuda]
    assert ev
    for e in ev:
        assert sp.start_ns <= e.start_ns() <= e.start_ns() + e.duration_ns() <= sp.end_ns


def _graph_admit(cfg, scfg, params, state, prompts, slots, Lp=64):
    """prefill_slots of `prompts` into `slots` of `state`."""
    from neutts_tpu_torch.runtime import batching

    dev = state.token.device
    toks = torch.zeros((len(prompts), Lp), dtype=torch.int32)
    for j, p in enumerate(prompts):
        toks[j, Lp - len(p):] = torch.tensor(p)
    return batching.prefill_slots(
        cfg, scfg, cfg.layout.speech_gen_end, params, state, toks.to(dev), torch.tensor([len(p) for p in prompts], dtype=torch.int32,
                                                  device=dev),
        torch.tensor(slots, dtype=torch.int32, device=dev))


@pytest.mark.parametrize("kv_dtype,greedy", [("int8", True), ("int4", True), ("int8", False)])
def test_segment_graph_matches_eager_staged(dev, kv_dtype, greedy):
    """W8A8 on the card: `decode_steps` (one capture, then replays of the
    segment's CUDA graph) against the eager `_decode_steps_staged` over four
    segments with a retirement and admissions between them: tokens, lens,
    active, the cache bytes and scales equal. Top-k sampling draws the same
    noise as the eager path from a registered generator of the same seed.
    The returned tensors alias none of the graph's buffers; a replay adds
    the eager segment's launches to `_build.launches`; a second state
    captures its own graph; one capture serves every later segment."""
    from neutts_tpu_torch import config
    from neutts_tpu_torch.runtime import batching
    from neutts_tpu_torch.utils import TRACER

    cfg = config.TINY.scaled(kv_dtype=kv_dtype)
    staged = "decode_attention_staged" + ("_int4" if kv_dtype == "int4" else "")
    lay = cfg.layout
    eos = lay.speech_gen_end
    params = bb.quantize_params(bb.init_params(cfg, seed=3, device=dev))
    scfg = config.SamplingConfig(greedy=greedy, min_new_tokens=4).constrained_to(lay)
    params = bb.add_speech_head(cfg, params)
    S = 16
    prompts = [[lay.speech_base + (7 * i + j) % 60 for j in range(5 + 3 * i)] for i in range(3)]
    def fresh():
        state = batching.SlotState.create(cfg, 4, dev, seed=5)
        return _graph_admit(cfg, scfg, params, state, prompts, [0, 1, 2])

    sA, sB = fresh(), fresh()
    with TRACER.on() as records:
        for r in range(4):
            if r == 2:  # slot 1 retires; slots 1 and 3 take new requests
                retire = torch.tensor([False, True, False, False], device=dev)
                sA, sB = (batching.retire_slots(s, retire) for s in (sA, sB))
                sA, sB = (_graph_admit(cfg, scfg, params, s, [prompts[0][::-1], prompts[2][:4]],
                                       [1, 3]) for s in (sA, sB))
            counts = [dict(_build.launches)]
            sA, outA = batching.decode_steps(cfg, scfg, eos, S, params, sA)
            counts.append(dict(_build.launches))
            sB, outB = batching._decode_steps_staged(cfg, scfg, eos, S, params, sB)
            counts.append(dict(_build.launches))
            # a replay counts the launches of the eager segment; the capture none
            ran = [{k: b[k] - a[k] for k in a} for a, b in zip(counts, counts[1:])]
            assert ran[0] == ran[1] and ran[0][staged] == S * cfg.n_layers, (r, ran)
            first = outA if r == 0 else first
            seg = sA.graphs[S]
            held = {t.data_ptr() for t in (*seg.result,
                                           *(getattr(seg.static, n) for n in batching._SLOT_INPUTS))}
            assert not held & {t.data_ptr() for t in (outA, sA.token, sA.lens, sA.active)}
            torch.cuda.synchronize()
            assert torch.equal(outA, outB), r
            for n in ("token", "lens", "active"):
                assert torch.equal(getattr(sA, n), getattr(sB, n)), (r, n)
            for f in ("k", "v", "k_scale", "v_scale"):
                assert torch.equal(getattr(sA.cache, f), getattr(sB.cache, f)), (r, f)
        names = [rec.name for rec in records]
        assert names.count("decode.capture") == 1 and names.count("decode.replay") == 3
        sC, outC = batching.decode_steps(cfg, scfg, eos, S, params, fresh())
        assert sC.graphs[S] is not sA.graphs[S]
        assert [rec.name for rec in records].count("decode.capture") == 2
    assert torch.equal(outC, first)


def _admission_groups(lay):
    """Two admission shapes, each twice: (2, 128), and (3, 64) padded by a
    duplicate slot (the engine's group padding)."""
    def code(i, n):
        return [lay.speech_base + (7 * i + j) % 60 for j in range(n)]

    return [([code(0, 5), code(1, 90)], [0, 4], 128),
            ([code(2, 7), code(3, 40), code(3, 40)], [1, 3, 3], 64),
            ([code(4, 100), code(5, 3)], [4, 5], 128),
            ([code(6, 11), code(7, 2), code(7, 2)], [0, 2, 2], 64)]


def _check_admit_graphs(dev, cfg, scfg, params, kernels):
    """`prefill_slots` (one graph per shape, captured on the shape's first
    call, then replayed) against the eager `_prefill_slots_eager` on a twin
    state, group by group: the five per-slot tensors (first tokens
    included), the cache's values and scales and an LFM2 conv state
    bit-equal; returned tensors alias none of the graph's buffers; each
    call adds the eager admission's launches to `_build.launches`
    (`kernels` among them); one `admit.capture` a shape, then
    `admit.replay`s alone, all in one memory pool; a decode segment after
    them keeps its own `decode.capture`."""
    from neutts_tpu_torch.runtime import batching
    from neutts_tpu_torch.utils import TRACER

    eos = cfg.layout.speech_gen_end
    sA, sB = (batching.SlotState.create(cfg, 6, dev, seed=5) for _ in range(2))
    slot_names = batching._SLOT_INPUTS
    with TRACER.on() as records:
        for prompts, slots, Lp in _admission_groups(cfg.layout):
            toks = torch.zeros((len(prompts), Lp), dtype=torch.int32)
            for j, pr in enumerate(prompts):
                toks[j, Lp - len(pr):] = torch.tensor(pr)
            lens = torch.tensor([len(pr) for pr in prompts], dtype=torch.int32)
            inputs = tuple(t.to(dev) for t in (toks, lens, torch.tensor(slots, dtype=torch.int32)))
            counts = [dict(_build.launches)]
            sA = batching.prefill_slots(cfg, scfg, eos, params, sA, *inputs)
            counts.append(dict(_build.launches))
            sB = batching._prefill_slots_eager(cfg, scfg, eos, params, sB, *inputs)
            counts.append(dict(_build.launches))
            ran = [{k: b[k] - a[k] for k in a} for a, b in zip(counts, counts[1:])]
            assert ran[0] == ran[1] and all(ran[0][k] > 0 for k in kernels), (Lp, ran)
            g = sA.admit_graphs[(len(prompts), Lp)]
            held = {t.data_ptr() for t in (*g.result, *g.inputs,
                                           *(getattr(g.static, n) for n in slot_names))}
            assert not held & {getattr(sA, n).data_ptr() for n in slot_names}
            torch.cuda.synchronize()
            for n in slot_names:
                assert torch.equal(getattr(sA, n), getattr(sB, n)), (Lp, n)
            for f in ("k", "v", "k_scale", "v_scale", "k_prev", "v_prev"):
                a, b = getattr(sA.cache, f), getattr(sB.cache, f)
                assert (a is None and b is None) or torch.equal(a, b), (Lp, f)
            if sA.conv is not None:
                assert torch.equal(sA.conv, sB.conv) and sA.conv.any(), Lp
        sA, _ = batching.decode_steps(cfg, scfg, eos, batching.segment_align(sA.cache), params, sA)
    names = [r.name for r in records]
    assert names.count("admit.capture") == 2 and names.count("admit.replay") == 2
    assert names.count("decode.capture") == 1 and "decode.replay" not in names
    assert [(r.attrs["rows"], r.attrs["bucket"]) for r in records
            if r.name == "admit.capture"] == [(2, 128), (3, 64)]
    pools = {g.pool for g in sA.admit_graphs.values()}
    assert len(sA.admit_graphs) == 2 and len(pools) == 1 and None not in pools


@pytest.mark.parametrize("kv_dtype,greedy", [("int8", True), ("int4", True), ("int8", False)])
def test_admit_graph_matches_eager_admission(dev, kv_dtype, greedy):
    """W8A8 on the card, int8 and int4 caches, greedy and top-k (a
    registered generator draws the eager path's noise): `_check_admit_graphs`."""
    from neutts_tpu_torch import config

    cfg = config.TINY.scaled(kv_dtype=kv_dtype)
    lay = cfg.layout
    params = bb.add_speech_head(cfg, bb.quantize_params(bb.init_params(cfg, seed=3, device=dev)))
    scfg = config.SamplingConfig(greedy=greedy, min_new_tokens=4).constrained_to(lay)
    scatter = "scatter_prefill4" if kv_dtype == "int4" else "scatter_prefill"
    _check_admit_graphs(dev, cfg, scfg, params, ("prefill_attention", scatter))


def test_engine_admitting_through_graphs_matches_eager(dev, monkeypatch):
    """A short W8A8 Engine run on the card, its admissions replaying their
    graphs, gives the tokens of the same run admitting eagerly
    (`_prefill_slots_eager` in `prefill_slots`'s place)."""
    from neutts_tpu_torch import config
    from neutts_tpu_torch.runtime import batching
    from neutts_tpu_torch.serving import Engine

    cfg = config.TINY.scaled(kv_dtype="int8")
    lay = cfg.layout
    params = bb.quantize_params(bb.init_params(cfg, seed=3, device=dev))
    scfg = config.SamplingConfig(greedy=True, min_new_tokens=4).constrained_to(lay)
    prompts = [[lay.speech_base + (5 * i + j) % 60 for j in range(3 + (37 * i) % 150)]
               for i in range(12)]
    results, kept = [], []
    for eager in (False, True):
        if eager:
            monkeypatch.setattr(batching, "prefill_slots", batching._prefill_slots_eager)
        eng = Engine(cfg, params, eos_id=lay.speech_gen_end, n_slots=4, sampling=scfg,
                     segment_steps=16, device=dev)
        rids = [eng.submit(p, max_new=20 + i) for i, p in enumerate(prompts)]
        out = eng.run()
        results.append([out[r] for r in rids])
        kept.append(len(eng.state.admit_graphs))
    assert results[0] == results[1] and all(len(t) == 20 + i for i, t in enumerate(results[0]))
    assert kept[0] > 1 and kept[1] == 0


@pytest.fixture()
def no_tf32():
    """Full-f32 products and convolutions (cuDNN takes TF32 by default)."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _tiny_pair(dev, kv_dtype="float32", codec_cfg=None):
    """The same seeded TINY pipeline on the CPU and on the card."""
    from neutts_tpu_torch import NeuTTS, config
    from neutts_tpu_torch.models import codec as cd
    from neutts_tpu_torch.text.g2p import RuleG2P

    cfg = config.TINY.scaled(kv_dtype=kv_dtype, max_context=224)
    ccfg = codec_cfg or config.CODEC_TINY
    params = bb.init_params(cfg, seed=5, device="cpu")
    cparams = cd.init_params(ccfg, seed=6, device="cpu")
    scfg = config.SamplingConfig(greedy=True, min_new_tokens=8,
                                 max_context=224).constrained_to(cfg.layout)
    return [NeuTTS(cfg, params, ccfg, cparams, g2p=RuleG2P(), watermarker=None, sampling=scfg,
                   device=d) for d in ("cpu", dev)]


@pytest.mark.parametrize("kv_dtype,first_chunk_frames", [("float32", 25), ("int8", 10)])
def test_tiny_stream_gpu_matches_cpu(dev, no_tf32, kv_dtype, first_chunk_frames):
    """infer_stream on the card (kernels #1 and #5) yields the chunks of the
    same stream on the CPU (plain versions): greedy tokens equal, so the
    same chunk sizes, samples within 1e-4 (f32 summation order; int8 KV
    within one quantization step of the same tokens)."""
    import dataclasses

    import numpy as np

    cpu, gpu = _tiny_pair(dev, kv_dtype)
    ref = np.random.default_rng(0).integers(0, 64, 24).astype(np.int32)
    for t in (cpu, gpu):
        t.streaming = dataclasses.replace(t.streaming, first_chunk_frames=first_chunk_frames)
    want = list(cpu.infer_stream("Hello there, this is a test.", ref, "So I'm live."))
    _build.reset_launches()
    got = list(gpu.infer_stream("Hello there, this is a test.", ref, "So I'm live."))
    assert _build.launches["prefill_attention"] > 0
    assert _build.launches["decode_attention_" + ("int8" if kv_dtype == "int8" else "bf16")] > 0
    assert [g.shape for g in got] == [w.shape for w in want] and len(got) >= 2
    for g, w in zip(got, want):
        assert g.dtype == np.float32
        np.testing.assert_allclose(g, w, atol=1e-4)
    assert gpu.last_stats["n_codes"] == cpu.last_stats["n_codes"]


@pytest.mark.parametrize("kv_dtype", ["float32", "int8", "int4"])
def test_decode_segment_never_waits_for_the_device(dev, kv_dtype):
    """A segment of 16 steps queues its work with no host synchronisation:
    the stream reads `done` once per segment, never inside one."""
    from neutts_tpu_torch import config
    from neutts_tpu_torch.runtime import decode as dec

    cfg = config.TINY.scaled(kv_dtype=kv_dtype, max_context=224)
    lay = cfg.layout
    params = bb.init_params(cfg, seed=3, device=dev)
    scfg = config.SamplingConfig(min_new_tokens=16, max_context=224).constrained_to(lay)
    toks, lens = dec.pad_prompts([[3, 1, 4, 1, 5], [9, 2]], pad_id=0, bucket=16, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    state, _ = dec.prefill_init(cfg, scfg, lay.speech_gen_end, params, toks, lens, gen)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, seg = dec.decode_segment(cfg, scfg, lay.speech_gen_end, 16, params, state)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert seg.shape == (2, 16) and not bool(state.done.any())


def _stream_model(dev, kv_dtype):
    """TINY with a speech head, bf16 weights and activations for a bf16 cache."""
    from neutts_tpu_torch import config

    dtype = "bfloat16" if kv_dtype == "bfloat16" else "float32"
    cfg = config.TINY.scaled(kv_dtype=kv_dtype, dtype=dtype, max_context=224)
    return cfg, bb.add_speech_head(cfg, bb.init_params(cfg, seed=3, device=dev))


def _stream_prefill(cfg, scfg, params, dev, prompts, bucket, gen):
    from neutts_tpu_torch.runtime import decode as dec

    toks, lens = dec.pad_prompts(prompts, pad_id=0, bucket=bucket, device=dev)
    return dec.prefill_init(cfg, scfg, cfg.layout.speech_gen_end, params, toks, lens, gen)[0]


@pytest.mark.parametrize("kv_dtype,greedy", [("bfloat16", True), ("int8", True), ("int8", False)])
def test_stream_graph_matches_eager(dev, kv_dtype, greedy):
    """`decode_segment` on the card (one capture, then replays of the
    segment's CUDA graph) against the host-index loop over four 12-step
    segments: tokens, done, lengths and the cache bytes equal. Top-k
    sampling draws the same noise from a registered generator of the same
    seed. A replay adds the eager segment's launches to `_build.launches`,
    the graph's count of one replay, and no returned tensor aliases the
    graph's buffers or captured result."""
    from neutts_tpu_torch import config
    from neutts_tpu_torch.runtime import decode as dec
    from neutts_tpu_torch.utils import TRACER

    cfg, params = _stream_model(dev, kv_dtype)
    eos = cfg.layout.speech_gen_end
    scfg = config.SamplingConfig(greedy=greedy, min_new_tokens=10_000,
                                 max_context=224).constrained_to(cfg.layout)
    sA, sB = (_stream_prefill(cfg, scfg, params, dev, [[3, 1, 4, 1, 5], [9, 2]], 16,
                              torch.Generator(device=dev).manual_seed(7)) for _ in range(2))
    S = 12
    attention = "decode_attention_" + ("int8" if kv_dtype == "int8" else "bf16")
    with TRACER.on() as records:
        for r in range(4):
            counts = [dict(_build.launches)]
            sA, outA = dec.decode_segment(cfg, scfg, eos, S, params, sA)
            counts.append(dict(_build.launches))
            with torch.inference_mode():
                sB, outB = dec._segment_host(cfg, scfg, eos, S, params, sB)
            counts.append(dict(_build.launches))
            ran = [{k: b[k] - a[k] for k in a} for a, b in zip(counts, counts[1:])]
            assert ran[0] == ran[1] and ran[0][attention] == S * cfg.n_layers, (r, ran)
            seg = list(dec._stream_graphs[sA.token.device.index].values())[-1]
            assert seg.launches == {k: n for k, n in ran[1].items() if n}, r
            held = {t.data_ptr() for t in (*seg.result, seg.index,
                                           *dec._cache_tensors(seg.static.cache),
                                           *(getattr(seg.static, n) for n in dec._STREAM_INPUTS))}
            assert not held & {t.data_ptr() for t in (outA, sA.token, sA.done, sA.lengths)}
            torch.cuda.synchronize()
            assert torch.equal(outA, outB), r
            for n in ("token", "done", "lengths"):
                assert torch.equal(getattr(sA, n), getattr(sB, n)), (r, n)
            for a, b in zip(dec._cache_tensors(sA.cache), dec._cache_tensors(sB.cache)):
                assert torch.equal(a, b), r
    names = [rec.name for rec in records]
    assert names.count("decode.capture") == 1 and names.count("decode.replay") == 3
    assert int(sA.lengths[0]) == 1 + 4 * S


def test_stream_graph_serves_every_later_stream(dev):
    """Two streams of one pipeline with other prompt buckets (16 and 32),
    interleaved segment by segment: one `decode.capture`, then
    `decode.replay`s alone, and each stream's tokens, lengths and cache are
    those of its host-index loop run alone."""
    from neutts_tpu_torch import config
    from neutts_tpu_torch.runtime import decode as dec
    from neutts_tpu_torch.utils import TRACER

    cfg, params = _stream_model(dev, "bfloat16")
    eos = cfg.layout.speech_gen_end
    scfg = config.SamplingConfig(greedy=True, min_new_tokens=10_000,
                                 max_context=224).constrained_to(cfg.layout)
    gen = torch.Generator(device=dev).manual_seed(0)
    streams = (([[3, 1, 4, 1, 5]], 16), ([list(range(3, 23))], 32))
    graphed = [_stream_prefill(cfg, scfg, params, dev, p, b, gen) for p, b in streams]
    alone = [_stream_prefill(cfg, scfg, params, dev, p, b, gen) for p, b in streams]
    got, want = [[], []], [[], []]
    with TRACER.on() as records:
        for _ in range(3):
            for j in (0, 1):
                graphed[j], out = dec.decode_segment(cfg, scfg, eos, 10, params, graphed[j])
                got[j].append(out)
    with torch.inference_mode():
        for j in (0, 1):
            for _ in range(3):
                alone[j], out = dec._segment_host(cfg, scfg, eos, 10, params, alone[j])
                want[j].append(out)
    names = [rec.name for rec in records if rec.name in ("decode.capture", "decode.replay")]
    assert names == ["decode.capture"] + ["decode.replay"] * 5
    torch.cuda.synchronize()
    for j in (0, 1):
        assert graphed[j].prompt_end == streams[j][1]
        assert all(torch.equal(a, b) for a, b in zip(got[j], want[j])), j
        assert torch.equal(graphed[j].lengths, alone[j].lengths)
        for a, b in zip(dec._cache_tensors(graphed[j].cache), dec._cache_tensors(alone[j].cache)):
            assert torch.equal(a, b), j


@pytest.mark.parametrize("composition", ["tiny", "small_real"])
def test_encoder_gpu_matches_cpu(dev, no_tf32, composition):
    """encode_reference(samples/demo.wav) on the card equals the CPU's codes,
    with the latent within 1e-4 of its scale: CODEC_TINY's from-scratch
    encoder, and the real composition (XCodec2 stack, w2v-BERT tower, conv
    SemanticEncoder) at a small width."""
    from pathlib import Path

    import numpy as np

    from neutts_tpu_torch import config
    from neutts_tpu_torch.audio import io as audio_io
    from neutts_tpu_torch.audio import mel
    from neutts_tpu_torch.models import codec as cd

    ccfg = config.CODEC_TINY
    if composition == "small_real":
        ccfg = ccfg.scaled(
            enc_family="codecenc",
            codecenc=config.CodecEncConfig(ngf=4, up_ratios=(2, 2, 4, 4, 5), dilations=(1, 3),
                                           out_channels=16, rnn_layers=1),
            semantic=config.SemanticConfig(hidden=16, n_layers=2, n_heads=2, intermediate=32,
                                           conv_kernel=5, left_max=4, right_max=2,
                                           output_layer=1),
            sem_proj_dim=8, sem_encoder="conv")
    cpu, gpu = _tiny_pair(dev, codec_cfg=ccfg)
    wav_path = Path(__file__).resolve().parent.parent / "samples" / "demo.wav"
    want = cpu.encode_reference(wav_path)
    got = gpu.encode_reference(wav_path)
    assert got.dtype == np.int32 and got.shape == (100,)
    np.testing.assert_array_equal(got, want)
    wav = audio_io.load_for_encoding(wav_path)
    sem = None
    if ccfg.semantic is not None:
        sem = torch.as_tensor(mel.semantic_features(np.pad(wav, (160, 160))))[None]
    zc = cd.encode_latent(ccfg, cpu.codec_params, torch.as_tensor(wav)[None], sem)
    zg = cd.encode_latent(ccfg, gpu.codec_params, torch.as_tensor(wav, device=dev)[None],
                          None if sem is None else sem.to(dev))
    scale = max(1.0, float(zc.abs().max()))
    torch.testing.assert_close(zg.cpu(), zc, rtol=0, atol=1e-4 * scale)


@pytest.mark.parametrize("remat", [False, True])
def test_forward_train_gradients_gpu_match_cpu(dev, no_tf32, remat):
    """A 2-layer, 64-wide f32 model: the training loss and every gradient on
    the card against the CPU (both plain torch: summation order only, 1e-4
    of each leaf's scale), and no kernel launched."""
    from neutts_tpu_torch import config
    from neutts_tpu_torch.models.checkpoint import tree_leaves, tree_to
    from neutts_tpu_torch.train import trainer as tr

    cfg = config.TINY
    rng = torch.Generator().manual_seed(0)
    toks = torch.randint(0, cfg.vocab_size, (2, 256), generator=rng, dtype=torch.int32)
    toks[:, 8] = cfg.layout.speech_gen_start
    mask = torch.ones(2, 256, dtype=torch.bool)
    mask[1, 200:] = False
    labels = tr.make_labels(toks, mask, cfg.layout.speech_gen_start)
    params = bb.init_params(cfg, seed=3, device="cpu")
    out = {}
    _build.reset_launches()
    for d in ("cpu", dev):
        loss, _, grads = tr.value_and_grad(
            lambda q: (tr.loss_fn(cfg, q, toks.to(d), labels.to(d), mask.to(d),
                                  remat=remat)[0], None), tree_to(params, d))
        out[str(d)] = (loss.cpu(), [g.cpu() for g in tree_leaves(grads)])
    assert not any(_build.launches.values()), _build.launches
    gpu, cpu = out[str(dev)], out["cpu"]
    torch.testing.assert_close(gpu[0], cpu[0], rtol=1e-5, atol=0)
    for g, c in zip(gpu[1], cpu[1]):
        torch.testing.assert_close(g, c, rtol=1e-4, atol=1e-4 * float(c.abs().max()))


def test_kernel_refuses_autograd_on_the_card(dev):
    """The device dispatch of #5 on CUDA tensors that require grad raises
    instead of launching a kernel with no backward; under no_grad it runs."""
    q = _randn(dev, 1, 64, 14, 64, dtype=torch.bfloat16).requires_grad_(True)
    k = _randn(dev, 1, 64, 2, 64, dtype=torch.bfloat16, seed=1)
    pads = torch.zeros(1, dtype=torch.int32, device=dev)
    before = _build.launches["prefill_attention"]
    with pytest.raises(RuntimeError, match="no backward"):
        attn.prefill_attention(q, k, k, pads)
    assert _build.launches["prefill_attention"] == before
    with torch.no_grad():
        attn.prefill_attention(q, k, k, pads)
    assert _build.launches["prefill_attention"] == before + 1


@pytest.mark.parametrize("source", ["hf_bf16", "gguf_q8_0"])
def test_converted_weights_on_the_card_equal_the_cpus(dev, tmp_path, source):
    """A TINY checkpoint converted onto the card (from_hf of a BF16 HF file,
    from_gguf of a Q8_0 GGUF) equals the same conversion on the CPU bit for
    bit, and so do its W8A8 weights (quantize_params on each device); the
    converted model's prefill on the card launches #5, #6 and #7."""
    from neutts_tpu_torch import config
    from neutts_tpu_torch.models import checkpoint as ckpt
    from neutts_tpu_torch.models import convert

    cfg = config.TINY.scaled(vocab_size=320 + 6 + 65_536, dtype="bfloat16")
    params = bb.init_params(cfg, seed=1, device="cpu")
    if source == "hf_bf16":
        convert.write_hf_dir(tmp_path, cfg, params)
        load = lambda d: convert.from_hf(tmp_path, device=d)  # noqa: E731
    else:
        gg = {k: v.float().contiguous().numpy() for k, v in
              convert.hf_to_gguf_tensors(cfg, convert.to_hf_tensors(cfg, params)).items()}
        convert.write_gguf(tmp_path / "m.gguf", convert.gguf_metadata(cfg), gg,
                           quant={k: "Q8_0" for k, v in gg.items() if v.ndim == 2})
        load = lambda d: convert.from_gguf(tmp_path / "m.gguf", device=d)  # noqa: E731
    ccfg, cpu = load("cpu")
    gcfg, gpu = load(dev)
    assert gcfg == ccfg and gpu["embed"].device.type == dev.type
    for g, c in zip(ckpt.tree_leaves(gpu), ckpt.tree_leaves(cpu)):
        assert g.dtype == c.dtype == torch.bfloat16
        assert torch.equal(g.cpu().view(torch.int16), c.view(torch.int16))
    qg, qc = bb.quantize_params(gpu), bb.quantize_params(cpu)
    for name in ("wq", "wqkv", "w_gate", "w_down"):
        for k in ("q", "s"):
            g, c = qg["layers"][name][k].cpu(), qc["layers"][name][k]
            assert torch.equal(g, c), (name, k, int((g != c).sum()))
    for g, c in zip(ckpt.tree_leaves(qg), ckpt.tree_leaves(qc)):
        assert torch.equal(g.cpu(), c)
    _build.reset_launches()
    toks = (torch.arange(4 * 512, device=dev) * 7 % cfg.vocab_size).to(torch.int32).view(4, 512)
    cache = bb.KVCache.create(gcfg.scaled(kv_dtype="int8"), 4, max_len=512, device=dev)
    logits, _ = bb.prefill(gcfg.scaled(kv_dtype="int8"), qg, toks,
                           torch.full((4,), 512, dtype=torch.int32, device=dev), cache)
    torch.cuda.synchronize()
    assert torch.isfinite(logits.float()).all()
    for k in ("prefill_attention", "fused_qkv", "fused_mlp"):  # M 2048 = FUSED_MIN_M
        assert _build.launches[k] > 0, k


def test_bf16_matmul_f32_result_and_backward(dev):
    """backbone.matmul_f32 on the card: bf16 operands give the f32 product
    of their values (`aten::mm.dtype`; a bf16-rounded result is ~2^-9 of
    the largest off), with and without autograd; the backward rounds the
    f32 cotangent to bf16 and multiplies in bf16, as the port did before:
    each gradient is the f32 product of those bf16 values rounded once to
    bf16, within one bf16 step (1e-2 relative) of it."""
    x = _randn(dev, 3, 40, 96, dtype=torch.bfloat16).requires_grad_(True)
    w = _randn(dev, 96, 136, dtype=torch.bfloat16, seed=1, scale=0.1).requires_grad_(True)
    x32, w32 = x.detach().float(), w.detach().float()
    exact = x32 @ w32
    y = bb.matmul_f32(x, w)
    assert y.dtype == torch.float32 and y.shape == (3, 40, 136)
    assert float((y.detach() - exact).abs().max()) <= 1e-5 * float(exact.abs().max())
    with torch.no_grad():
        torch.testing.assert_close(bb.matmul_f32(x, w), y.detach(), rtol=0, atol=0)
    g = _randn(dev, 3, 40, 136, seed=2)
    y.backward(g)
    g16 = g.bfloat16().float().reshape(-1, 136)
    want_x = (g16 @ w32.T).bfloat16().reshape(x.shape)
    want_w = (x32.reshape(-1, 96).T @ g16).bfloat16()
    for got, want in ((x.grad, want_x), (w.grad, want_w)):
        assert got.dtype == torch.bfloat16
        torch.testing.assert_close(got.float(), want.float(), rtol=1e-2, atol=1e-6)


def _moe_case(dev, T, E=32, k=4, D=2048, Fe=1792, empty=(5,), seed=0):
    """Seeded bf16 tokens and experts at LFM2-8B-A1B's widths, routed top-k
    over random scores; the experts in `empty` take no rows."""
    from neutts_tpu_torch.ops import moe as moe_ops

    x = _randn(dev, T, D, dtype=torch.bfloat16, seed=seed)
    wg = _randn(dev, E, D, Fe, dtype=torch.bfloat16, seed=seed + 1, scale=D ** -0.5)
    wu = _randn(dev, E, D, Fe, dtype=torch.bfloat16, seed=seed + 2, scale=D ** -0.5)
    wd = _randn(dev, E, Fe, D, dtype=torch.bfloat16, seed=seed + 3, scale=Fe ** -0.5)
    scores = _randn(dev, T, E, seed=seed + 4)
    scores[:, list(empty)] = -float("inf")
    idx = torch.topk(scores, k, dim=-1).indices
    perm, offsets, counts = moe_ops.sort_pairs(idx, E)
    return x, wg, wu, wd, idx, perm, offsets, counts


@pytest.mark.parametrize("T", [256, 64 * 512], ids=["decode_256x4", "admission_64x512x4"])
def test_moe_grouped_kernel(dev, T):
    """The grouped SwiGLU expert kernel against its plain version at the
    serving decode shape (256 tokens x top 4) and an admission's (64 x 512
    tokens x top 4), LFM2-8B-A1B widths, with an expert of no rows. Both
    round the SwiGLU activation to bf16; their f32 sums differ in order, so
    an activation may round one bf16 step apart: 1e-2 of the output range.
    The kernel is deterministic and one wrapper call."""
    from neutts_tpu_torch.ops import moe as moe_ops

    x, wg, wu, wd, idx, perm, offsets, counts = _moe_case(dev, T)
    assert int(counts[5]) == 0
    before = _build.launches["moe_experts"]
    y = moe_ops.grouped_swiglu(x, perm, offsets, wg, wu, wd, 4)
    assert _build.launches["moe_experts"] == before + 1
    want = moe_ops.grouped_swiglu_plain(x, perm, offsets, wg, wu, wd, 4)
    torch.cuda.synchronize()
    assert torch.isfinite(y).all()
    err = (y - want).abs().max().item()
    assert err <= 1e-2 * want.abs().max().item(), err
    assert torch.equal(y, moe_ops.grouped_swiglu(x, perm, offsets, wg, wu, wd, 4))


def test_moe_kernel_refuses_what_it_cannot_take(dev):
    from neutts_tpu_torch.ops import moe as moe_ops

    x, wg, wu, wd, idx, perm, offsets, _ = _moe_case(dev, 16, E=4, k=2, D=128, Fe=64, empty=())
    with pytest.raises(TypeError):
        moe_ops.grouped_swiglu(x.float(), perm, offsets, wg, wu, wd, 2)
    with pytest.raises(ValueError):
        moe_ops.grouped_swiglu(x[:, :96].contiguous(), perm, offsets, wg[:, :96].contiguous(),
                               wu[:, :96].contiguous(), wd[..., :96].contiguous(), 2)


def _lfm2_card_cfg():
    """A small LFM2-MoE the kernels take: hidden 128, heads of 64, 8 experts
    of 64 (top 2), the conv/attention pattern, bf16, int8 KV."""
    from neutts_tpu_torch import config

    return config.LFM2_TINY.scaled(hidden_size=128, n_heads=4, n_kv_heads=2, head_dim=64,
                                   intermediate_size=256, moe_intermediate_size=64,
                                   dtype="bfloat16", kv_dtype="int8")


def test_lfm2_segment_graph_matches_eager_staged(dev):
    """An LFM2-MoE on the card: `decode_steps` (one capture, then replays)
    against the eager `_decode_steps_staged` over four segments with a
    retirement and admissions between them: tokens, lens, active, the cache,
    the conv state and the expert counts equal. One capture per state and
    step count: a second state and another step count each capture their
    own graph, and a replay counts the expert kernel's launches."""
    from neutts_tpu_torch import config
    from neutts_tpu_torch.models import lfm2
    from neutts_tpu_torch.runtime import batching
    from neutts_tpu_torch.utils import TRACER

    cfg = _lfm2_card_cfg()
    lay = cfg.layout
    eos = lay.speech_gen_end
    params = bb.add_speech_head(cfg, lfm2.init_params(cfg, seed=3, device=dev))
    scfg = config.SamplingConfig(greedy=True, min_new_tokens=4).constrained_to(lay)
    S = 16
    prompts = [[lay.speech_base + (7 * i + j) % 60 for j in range(5 + 3 * i)] for i in range(3)]

    def fresh():
        state = batching.SlotState.create(cfg, 4, dev, seed=5)
        return _graph_admit(cfg, scfg, params, state, prompts, [0, 1, 2])

    sA, sB = fresh(), fresh()
    moe_layers = cfg.n_moe_layers
    with TRACER.on() as records:
        for r in range(4):
            if r == 2:
                retire = torch.tensor([False, True, False, False], device=dev)
                sA, sB = (batching.retire_slots(s, retire) for s in (sA, sB))
                sA, sB = (_graph_admit(cfg, scfg, params, s, [prompts[0][::-1], prompts[2][:4]],
                                       [1, 3]) for s in (sA, sB))
            n0 = _build.launches["moe_experts"]
            sA, outA = batching.decode_steps(cfg, scfg, eos, S, params, sA)
            n1 = _build.launches["moe_experts"]
            sB, outB = batching._decode_steps_staged(cfg, scfg, eos, S, params, sB)
            assert n1 - n0 == _build.launches["moe_experts"] - n1 == S * moe_layers, r
            torch.cuda.synchronize()
            assert torch.equal(outA, outB), r
            for n in ("token", "lens", "active", "conv", "expert_rows"):
                assert torch.equal(getattr(sA, n), getattr(sB, n)), (r, n)
            for f in ("k", "v", "k_scale", "v_scale"):
                assert torch.equal(getattr(sA.cache, f), getattr(sB.cache, f)), (r, f)
        assert int(sA.expert_rows[:, 0].sum()) == 4 * S * 4 * cfg.n_experts_per_tok * moe_layers
        names = [rec.name for rec in records]
        assert names.count("decode.capture") == 1 and names.count("decode.replay") == 3
        sC, _ = batching.decode_steps(cfg, scfg, eos, S, params, fresh())
        assert sC.graphs[S] is not sA.graphs[S]
        sA, _ = batching.decode_steps(cfg, scfg, eos, 8, params, sA)
        assert set(sA.graphs) == {8, S}
        assert [rec.name for rec in records].count("decode.capture") == 3


def test_lfm2_admit_graph_matches_eager_admission(dev):
    """An LFM2-MoE on the card: `_check_admit_graphs`, the conv state and
    the expert kernel's launches among what the graph must reproduce."""
    from neutts_tpu_torch import config
    from neutts_tpu_torch.models import lfm2

    cfg = _lfm2_card_cfg()
    params = bb.add_speech_head(cfg, lfm2.init_params(cfg, seed=3, device=dev))
    scfg = config.SamplingConfig(greedy=True, min_new_tokens=4).constrained_to(cfg.layout)
    _check_admit_graphs(dev, cfg, scfg, params,
                        ("prefill_attention", "scatter_prefill", "moe_experts"))


@pytest.mark.skipif(torch.cuda.device_count() < 2, reason="needs a second card")
def test_readback_waits_on_the_tensors_own_card():
    """A `MultiChipEngine` replica reads back from a card that is not the
    current device: `_Readback.wait` must wait for that card's queued work,
    not the current device's."""
    from neutts_tpu_torch.serving.engine import _Readback

    other = torch.device("cuda", 1)
    with torch.cuda.device(0):
        for _ in range(3):
            x = torch.zeros(1 << 16, dtype=torch.int32, device=other)
            torch.cuda.synchronize(other)
            with torch.cuda.device(other):
                torch.cuda._sleep(200_000_000)  # ~0.1 s of the other card's stream
            x.fill_(7)
            rb = _Readback(x)
            assert rb.event is not None
            (got,) = rb.wait()
            assert (got == 7).all()
