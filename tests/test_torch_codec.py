"""Port codec decoder and ExactVocoder against the JAX package (CODEC_TINY,
JAX weights handed over through params_from_numpy).

Tolerance: the waveforms are f32 end to end in both packages; they differ by
summation order in the matmuls, convolutions and FFTs only — 1e-5 absolute
on samples bounded by 1 (tests/test_vocoder.py allows 2e-6 between two JAX
compilations of one graph; other kernels reorder more).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neutts_tpu import config as jcfg
from neutts_tpu.models import codec as jcd
from neutts_tpu.runtime.vocoder import ExactVocoder as JExactVocoder
from neutts_tpu_torch import config
from neutts_tpu_torch.models import codec as tcd
from neutts_tpu_torch.models.checkpoint import params_from_numpy
from neutts_tpu_torch.runtime.vocoder import ExactVocoder

ATOL = 1e-5


def _both(backbone="transformer", seed=0):
    jc = jcfg.CODEC_TINY.scaled(dec_backbone=backbone)
    jp = jcd.init_params(jc, jax.random.PRNGKey(seed))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return jc, jp, config.CODEC_TINY.scaled(dec_backbone=backbone), tp


@pytest.mark.parametrize("backbone", ["transformer", "convnext"])
def test_decode_matches_jax(backbone):
    jc, jp, tc, tp = _both(backbone)
    codes = np.random.default_rng(0).integers(0, 65_536, size=(2, 37)).astype(np.int32)
    want = np.asarray(jcd.decode(jc, jp, jnp.asarray(codes)))
    got = tcd.decode(tc, tp, torch.from_numpy(codes)).numpy()
    assert got.shape == (2, 37 * 480) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("backbone", ["transformer", "convnext"])
def test_masked_decode_matches_unpadded(backbone):
    """Length-masked decode at a padded length == exact-length decode."""
    _, _, tc, tp = _both(backbone, seed=1)
    codes = np.random.default_rng(1).integers(0, 65_536, size=23).astype(np.int64)
    padded = np.zeros(64, np.int64)
    padded[:23] = codes
    want = tcd.decode(tc, tp, torch.from_numpy(codes)[None])
    got = tcd.decode(tc, tp, torch.from_numpy(padded)[None], n_valid=23)[:, : 23 * 480]
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6)


def test_exact_vocoder_matches_jax():
    jc, jp, tc, tp = _both()
    codes = np.random.default_rng(2).integers(0, 65_536, size=73).astype(np.int32)
    want = JExactVocoder(jc, jp)(codes)
    got = ExactVocoder(tc, tp, device="cpu")(codes)
    assert got.shape == (73 * 480,)
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("k,dilation,groups,stride", [
    (7, 1, 1, 1), (4, 1, 1, 1),   # odd and even kernels: XLA puts the extra pad right
    (3, 3, 1, 1), (7, 1, 6, 1),   # dilation; depthwise (groups == channels)
    (5, 1, 1, 2),                 # strided "SAME"
])
def test_conv1d_layout_matches_jax(k, dilation, groups, stride):
    """JAX NWC / WIO "SAME" convs vs the port's transposition to torch's
    NCW / [out, in/groups, k] with explicit XLA-style padding."""
    rng = np.random.default_rng(3)
    cin = 6
    x = rng.normal(size=(2, 19, cin)).astype(np.float32)
    w = rng.normal(size=(k, cin // groups, 6)).astype(np.float32)
    b = rng.normal(size=(6,)).astype(np.float32)
    want = np.asarray(jcd.conv1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), stride=stride,
                                 dilation=dilation, groups=groups))
    got = tcd.conv1d(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
                     stride=stride, dilation=dilation, groups=groups).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_codec_rope_is_interleaved():
    """The codec's RoPE rotates pairs (2i, 2i+1) — not the backbone's
    half-split — and matches JAX."""
    cfg = config.CODEC_TINY
    rng = np.random.default_rng(4)
    x = rng.normal(size=(1, 5, cfg.dec_heads, cfg.head_dim)).astype(np.float32)
    jc, js = jcd._rope_tables(jcfg.CODEC_TINY, 5)
    tc, ts = tcd._rope_tables(cfg, 5, "cpu")
    got = tcd._apply_rope(torch.from_numpy(x), tc, ts).numpy()
    np.testing.assert_allclose(got, np.asarray(jcd._apply_rope(jnp.asarray(x), jc, js)),
                               rtol=1e-6, atol=1e-6)
    e = np.zeros((1, 2, 1, cfg.head_dim), np.float32)
    e[0, 1, 0, 0] = 1.0
    r = tcd._apply_rope(torch.from_numpy(e), tc[:2], ts[:2]).numpy()[0, 1, 0]
    assert r[1] != 0 and r[cfg.head_dim // 2] == 0


def test_fsq_and_istft_helpers_match_jax():
    levels = config.CODEC.fsq_levels
    codes = np.arange(0, 65_536, 97, dtype=np.int32)
    jd = jcd.code_to_digits(jnp.asarray(codes), levels)
    td = tcd.code_to_digits(torch.from_numpy(codes), levels)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tcd.fsq_dequantize(td, levels).numpy(),
                                  np.asarray(jcd.fsq_dequantize(jd, levels)))
    np.testing.assert_allclose(tcd.hann_window(1920).numpy(), np.asarray(jcd.hann_window(1920)),
                               atol=1e-7)
    rng = np.random.default_rng(5)
    re, im = (rng.normal(size=(1, 9, 961)).astype(np.float32) for _ in range(2))
    for n_valid in (None, 6):
        want = np.asarray(jcd.istft_same(jnp.asarray(re), jnp.asarray(im), 1920, 480,
                                         n_valid=n_valid))
        got = tcd.istft_same(torch.from_numpy(re), torch.from_numpy(im), 1920, 480,
                             n_valid=n_valid).numpy()
        # masked mode: only the valid samples carry meaning (past them the
        # envelope is ~0 and both divide rounding noise by it)
        n = got.shape[1] if n_valid is None else n_valid * 480
        np.testing.assert_allclose(got[:, :n], want[:, :n], rtol=1e-4, atol=1e-5)
