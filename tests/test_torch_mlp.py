"""Port W8A8 projections (neutts_tpu_torch.ops.mlp) against the JAX package.

The plain versions run here on the CPU; the Pallas kernels run in interpret
mode. Mirrors tests/test_mlp.py. Tolerance: one quantization step. The
int8 rounding boundaries are ulp-sensitive, so a different summation order
in rms_norm (or an f32 vs bf16 rounding of the activation) can flip an
activation by one int8 step; the tests bound the gap at 2e-2 (3e-2 where a
flip passes through the second, ff, quantization) of the output's range.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neutts_tpu.models import backbone as jbb
from neutts_tpu.ops import mlp as jmlp
from neutts_tpu_torch.models import backbone as tbb
from neutts_tpu_torch.ops import mlp as tmlp


def _weights(rng, d, f):
    wg = rng.normal(size=(d, f)) * d**-0.5
    wu = rng.normal(size=(d, f)) * d**-0.5
    wd = rng.normal(size=(f, d)) * f**-0.5
    qs = [jbb.quantize_weight(jnp.asarray(w, jnp.float32)) for w in (wg, wu, wd)]
    nw = (rng.normal(size=(d,)) * 0.1 + 1.0).astype(np.float32)
    return nw, [{k: np.array(v) for k, v in q.items()} for q in qs]


def _rel_err(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def test_quantize_weight_matches():
    rng = np.random.default_rng(7)
    w = rng.normal(size=(3, 32, 48)).astype(np.float32)
    jq = jbb.quantize_weight(jnp.asarray(w))
    tq = tbb.quantize_weight(torch.from_numpy(w))
    np.testing.assert_array_equal(tq["q"].numpy(), np.asarray(jq["q"]))
    np.testing.assert_allclose(tq["s"].numpy(), np.asarray(jq["s"]), rtol=1e-7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,d,f", [(64, 128, 256), (128, 256, 384)])
def test_fused_mlp_matches_kernel_and_oracle(m, d, f, dtype):
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(m, d)) * 0.5).astype(np.float32)
    nw, (qg, qu, qd) = _weights(rng, d, f)
    jx = jnp.asarray(x, dtype)
    jargs = (jx, jnp.asarray(nw), qg["q"], qg["s"], qu["q"], qu["s"], qd["q"], qd["s"])
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    targs = [torch.from_numpy(a) for a in (nw, qg["q"], qg["s"], qu["q"], qu["s"], qd["q"],
                                          qd["s"])]
    got = tmlp.fused_mlp(tx, *targs).float().numpy()
    want_or = jmlp.fused_mlp_xla(*jargs)
    assert _rel_err(got, want_or) <= 2e-2
    if m % 64 == 0:
        want_k = jmlp.fused_mlp(*jargs, interpret=True)
        assert _rel_err(got, want_k) <= 2e-2


@pytest.mark.parametrize("k_major", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_qkv_matches_kernel_and_oracle(dtype, k_major):
    """fused_qkv plain vs the Pallas kernel, its XLA oracle (which also
    rounds the normed activation through the model dtype), and the separate
    rms_norm + three _mm projections of the port; with the fused weight
    row-major (the JAX layout) and K-major (the port's stored layout,
    `backbone.k_major`)."""
    rng = np.random.default_rng(4)
    d, qd, kv, m = 128, 128, 64, 64
    x = (rng.normal(size=(m, d)) * 0.5).astype(np.float32)
    nw = (rng.normal(size=(d,)) * 0.1 + 1.0).astype(np.float32)
    ws = [rng.normal(size=(d, w)).astype(np.float32) * d**-0.5 for w in (qd, kv, kv)]
    bs = [(rng.normal(size=(w,)) * 0.05).astype(np.float32) for w in (qd, kv, kv)]
    qs = [{k: np.array(v) for k, v in jbb.quantize_weight(jnp.asarray(w)).items()} for w in ws]
    wq = np.concatenate([z["q"] for z in qs], -1)
    sq = np.concatenate([z["s"] for z in qs], -1)
    bq = np.concatenate(bs, -1)
    jx = jnp.asarray(x, dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    tw = torch.from_numpy(wq)
    if k_major:
        tw = tbb.k_major(tw)
        assert tw.mT.is_contiguous() and not tw.is_contiguous()
    got = tmlp.fused_qkv(tx, torch.from_numpy(nw), tw, torch.from_numpy(sq),
                         torch.from_numpy(bq))
    assert got.dtype == tx.dtype
    got = got.float().numpy()
    jargs = (jx, jnp.asarray(nw), wq, sq, bq)
    assert _rel_err(got, jmlp.fused_qkv(*jargs, interpret=True)) <= 2e-2
    assert _rel_err(got, jmlp.fused_qkv_xla(*jargs)) <= 2e-2
    h = tbb.rms_norm(tx, torch.from_numpy(nw), 1e-6)
    parts = [tbb._mm(h, {k: torch.from_numpy(v) for k, v in z.items()}) + torch.from_numpy(c)
             for z, c in zip(qs, bs)]
    assert _rel_err(got, torch.cat(parts, -1).numpy()) <= 3e-2


def test_mm_int8_matches_jax():
    """backbone._mm with a quantized weight: the same int8 activations and
    exact int32 product as the JAX `_mm` (f32 input: bit-equal quantization),
    so outputs agree to f32 rounding."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(3, 5, 96)).astype(np.float32)
    w = rng.normal(size=(96, 40)).astype(np.float32)
    jw = jbb.quantize_weight(jnp.asarray(w))
    want = np.asarray(jbb._mm(jnp.asarray(x), jw))
    got = tbb._mm(torch.from_numpy(x), {k: torch.from_numpy(np.array(v)) for k, v in jw.items()})
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_int8_matmul_is_exact():
    rng = np.random.default_rng(6)
    a = rng.integers(-127, 128, (5, 64)).astype(np.int8)
    b = rng.integers(-127, 128, (64, 24)).astype(np.int8)
    got = tmlp.int8_matmul(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), a.astype(np.int64) @ b.astype(np.int64))
