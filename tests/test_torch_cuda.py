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
    w = bb.quantize_weight(_randn(dev, D, N, seed=2, scale=D**-0.5))
    b = _randn(dev, N, seed=3, scale=0.05)
    got = mlp_ops.fused_qkv(x, nw, w["q"], w["s"], b)
    want = mlp_ops.fused_qkv_plain(x, nw, w["q"], w["s"], b)
    assert float((got.float() - want.float()).abs().max()) <= 2e-2 * float(want.abs().max())
    args = (x, nw, *_mlp_weights(dev, D, F))
    got = mlp_ops.fused_mlp(*args)
    want = mlp_ops.fused_mlp_plain(*args)
    assert float((got.float() - want.float()).abs().max()) <= 3e-2 * float(want.abs().max())


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
