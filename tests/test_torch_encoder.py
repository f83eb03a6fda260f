"""The port's encoder side (voice cloning) against the JAX package: audio
I/O, the native frontend, the log-mel front end, the XCodec2 acoustic stack
(`codecenc`), the w2v-BERT semantic tower, codec `encode` and
`NeuTTS.encode_reference`. JAX weights reach the port through
`params_from_numpy` or one `save_pipeline` checkpoint; inputs are made from
a seed with numpy.

Tolerances: the host front ends are the same numpy code in both packages,
so equal. The device side is f32 in both, differing by summation order in
convolutions, products and the LSTM recurrence only: 1e-5 of the output's
scale, max(1, max |want|) (1e-5 absolute on outputs bounded by 1, as the
decoder's tests/test_torch_codec.py; the acoustic stack's features reach
~12 and the FSQ latent more, where 1e-5 absolute is under 100 float32 ulps
of a 13-convolution chain). Codes must be equal.
"""

import dataclasses
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neutts_tpu import config as jcfg
from neutts_tpu.audio import io as jio
from neutts_tpu.audio import mel as jmel
from neutts_tpu.audio.overlap_add import linear_overlap_add
from neutts_tpu.models import backbone as jbb
from neutts_tpu.models import checkpoint as jckpt
from neutts_tpu.models import codec as jcd
from neutts_tpu.models import codecenc as jce
from neutts_tpu.models import semantic as jsem
from neutts_tpu.pipeline import NeuTTS as JNeuTTS
from neutts_tpu.text.g2p import RuleG2P as JRuleG2P
from neutts_tpu_torch import NeuTTS, config
from neutts_tpu_torch.audio import io as tio
from neutts_tpu_torch.audio import mel as tmel
from neutts_tpu_torch.models import checkpoint as tckpt
from neutts_tpu_torch.models import codec as tcd
from neutts_tpu_torch.models import codecenc as tce
from neutts_tpu_torch.models import semantic as tsem
from neutts_tpu_torch.models.checkpoint import params_from_numpy
from neutts_tpu_torch.text.g2p import RuleG2P

ATOL = 1e-5
DEMO_WAV = "samples/demo.wav"


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(tree):
    return params_from_numpy(_np(tree), "cpu")


def _small_real(jax_side: bool):
    """The real NeuCodec encoder composition at a small width: the XCodec2
    stack with the hop kept at 320, one LSTM layer, the semantic tower sized
    as tests/test_codec.py sizes it, and the conv SemanticEncoder."""
    c = jcfg if jax_side else config
    return c.CODEC_TINY.scaled(
        enc_family="codecenc",
        codecenc=c.CodecEncConfig(ngf=4, up_ratios=(2, 2, 4, 4, 5), dilations=(1, 3),
                                  out_channels=16, rnn_layers=1),
        semantic=c.SemanticConfig(input_dim=160, hidden=16, n_layers=1, n_heads=2,
                                  intermediate=32, conv_kernel=5, left_max=4, right_max=2,
                                  output_layer=1),
        sem_proj_dim=8, sem_encoder="conv")


def close(got, want):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, want, atol=ATOL * max(1.0, float(np.abs(want).max())))


def _demo_wav():
    return jio.load_for_encoding(DEMO_WAV, prefer_native=False)


# --- host front ends: copies, equal ------------------------------------------------


def test_semantic_features_equal_jax():
    wav = np.pad(_demo_wav(), (160, 160))
    np.testing.assert_array_equal(tmel.semantic_features(wav), jmel.semantic_features(wav))
    noise = (np.random.default_rng(0).standard_normal(7_777) * 0.1).astype(np.float32)
    np.testing.assert_array_equal(tmel.log_mel(noise), jmel.log_mel(noise))


def test_io_functions_equal_jax(tmp_path):
    x, sr = tio.read_wav(DEMO_WAV)
    y, sr2 = jio.read_wav(DEMO_WAV)
    assert sr == sr2 == 16_000 and x.shape == (32_000,)
    np.testing.assert_array_equal(x, y)
    stereo = np.stack([x, -0.5 * x], axis=1)
    np.testing.assert_array_equal(tio.to_mono(stereo), jio.to_mono(stereo))
    for sr_out in (24_000, 22_050):
        np.testing.assert_array_equal(tio.resample(x, 16_000, sr_out),
                                      jio.resample(x, 16_000, sr_out))
    tio.write_wav(tmp_path / "t.wav", stereo, 22_050)
    jio.write_wav(tmp_path / "j.wav", stereo, 22_050)
    assert (tmp_path / "t.wav").read_bytes() == (tmp_path / "j.wav").read_bytes()
    for native in (False, True):
        np.testing.assert_array_equal(
            tio.load_for_encoding(tmp_path / "t.wav", prefer_native=native),
            jio.load_for_encoding(tmp_path / "j.wav", prefer_native=native))


def test_native_matches_scipy(tmp_path):
    """The port's C++ frontend, built into neutts_tpu_torch/_build/."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the native audio frontend")
    from neutts_tpu_torch import native

    assert native.available()
    assert native._so_path().parent.name == "_build"
    a, sr_a = native.read_wav(DEMO_WAV)
    b, sr_b = tio.read_wav(DEMO_WAV)
    assert sr_a == sr_b
    np.testing.assert_allclose(a, b, atol=1e-6)
    x = (np.random.default_rng(0).standard_normal(44_100) * 0.3).astype(np.float32)
    for sr_in, sr_out in [(44_100, 16_000), (22_050, 16_000), (16_000, 24_000)]:
        got = native.resample(x, sr_in, sr_out)
        want = tio.resample(x, sr_in, sr_out)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=5e-5)
    tone = np.tanh(np.sin(np.arange(1000) / 50.0)).astype(np.float32)
    native.write_wav(tmp_path / "n.wav", tone, 24_000)
    y, sr = tio.read_wav(tmp_path / "n.wav")
    assert sr == 24_000
    np.testing.assert_allclose(y, tone, atol=1.0 / 32767 + 1.0 / 65536)
    frames = np.random.default_rng(1).standard_normal((5, 150)).astype(np.float32)
    np.testing.assert_allclose(native.overlap_add(frames, stride=100),
                               linear_overlap_add(list(frames), stride=100), atol=1e-6)


# --- the XCodec2 acoustic stack ------------------------------------------------------


def _enc_cfgs(alias_free=True, logscale=True):
    kw = dict(ngf=4, up_ratios=(2, 4, 5), dilations=(1, 3), out_channels=12, rnn_layers=2,
              alias_free=alias_free, snake_logscale=logscale)
    return jcfg.CodecEncConfig(**kw), config.CodecEncConfig(**kw)


def _perturbed_snakes(tree, rng):
    """Move every snake alpha/beta off its init, so the activation is exercised."""
    if isinstance(tree, dict):
        if "alpha" in tree:
            return {k: v + 0.3 * rng.standard_normal(v.shape).astype(np.float32)
                    for k, v in tree.items()}
        return {k: _perturbed_snakes(v, rng) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_perturbed_snakes(v, rng) for v in tree]
    return tree


@pytest.mark.parametrize("kernel", [12, 7])
def test_resampling_matches_jax(kernel):
    x = np.random.default_rng(0).standard_normal((2, 40, 3)).astype(np.float32)
    up = tce.upsample2(torch.from_numpy(x), kernel)
    want_up = np.asarray(jce.upsample2(jnp.asarray(x), kernel))
    assert up.shape == (2, 80, 3)
    np.testing.assert_allclose(up.numpy(), want_up, atol=1e-6)
    down = tce.downsample2(up, kernel)
    want_down = np.asarray(jce.downsample2(jnp.asarray(want_up), kernel))
    assert down.shape == (2, 40, 3)
    np.testing.assert_allclose(down.numpy(), want_down, atol=1e-6)
    np.testing.assert_array_equal(tce.kaiser_sinc_filter1d(0.25, 0.3, kernel),
                                  jce.kaiser_sinc_filter1d(0.25, 0.3, kernel))


@pytest.mark.parametrize("alias_free,logscale,with_beta", [
    (True, True, True), (False, False, True), (False, False, False),
])
def test_snake_and_act1d_match_jax(alias_free, logscale, with_beta):
    jc, tc = _enc_cfgs(alias_free, logscale)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 30, 5)).astype(np.float32)
    p = {"alpha": (0.5 + 0.3 * rng.standard_normal(5)).astype(np.float32)}
    if with_beta:
        p["beta"] = (0.7 + 0.3 * rng.standard_normal(5)).astype(np.float32)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    for jf, tf in ((jce.snake, tce.snake), (jce.act1d, tce.act1d)):
        want = np.asarray(jf(jc, jp, jnp.asarray(x)))
        got = tf(tc, tp, torch.from_numpy(x)).numpy()
        close(got, want)


@pytest.fixture(scope="module")
def enc_params():
    """JAX acoustic-stack weights, snakes perturbed (numpy tree)."""
    jc, _ = _enc_cfgs()
    return _perturbed_snakes(_np(jce.init_params(jc, jax.random.PRNGKey(3))),
                             np.random.default_rng(3))


def test_residual_unit_and_block_match_jax(enc_params):
    jc, tc = _enc_cfgs()
    tp = params_from_numpy(enc_params, "cpu")
    blk_j = jax.tree_util.tree_map(jnp.asarray, enc_params["blocks"][0])
    x = np.random.default_rng(4).standard_normal((2, 40, 4)).astype(np.float32)
    want = np.asarray(jce.residual_unit(jc, blk_j["units"][1], jnp.asarray(x), 3))
    got = tce.residual_unit(tc, tp["blocks"][0]["units"][1], torch.from_numpy(x), 3)
    close(got, want)
    want = np.asarray(jce.encoder_block(jc, blk_j, jnp.asarray(x), 2))
    got = tce.encoder_block(tc, tp["blocks"][0], torch.from_numpy(x), 2)
    assert got.shape == (2, 20, 8)
    close(got, want)


def test_lstm_matches_jax_and_torch_lstm(enc_params):
    layers = enc_params["lstm"]
    x = np.random.default_rng(5).standard_normal((2, 9, 32)).astype(np.float32)
    want = np.asarray(jce.slstm(jax.tree_util.tree_map(jnp.asarray, layers), jnp.asarray(x)))
    tl = params_from_numpy(layers, "cpu")
    got = tce.slstm(tl, torch.from_numpy(x))
    close(got, want)
    # the written-out recurrence is torch.nn.LSTM's (gate order i, f, g, o)
    ref = torch.nn.LSTM(32, 32, num_layers=2, batch_first=True)
    with torch.no_grad():
        for i, lp in enumerate(tl):
            for name in ("w_ih", "w_hh", "b_ih", "b_hh"):
                kind, part = name.split("_")
                getattr(ref, f"{'weight' if kind == 'w' else 'bias'}_{part}_l{i}").copy_(lp[name])
        y, _ = ref(torch.from_numpy(x))
    close(got, x + y.numpy())


@pytest.mark.parametrize("alias_free", [True, False])
def test_codecenc_forward_matches_jax(alias_free):
    jc, tc = _enc_cfgs(alias_free, logscale=alias_free)
    jp = _perturbed_snakes(_np(jce.init_params(jc, jax.random.PRNGKey(6))),
                           np.random.default_rng(6))
    wav = (np.random.default_rng(6).standard_normal((2, 400)) * 0.3).astype(np.float32)
    want = np.asarray(jce.forward(jc, jax.tree_util.tree_map(jnp.asarray, jp),
                                  jnp.asarray(wav)))
    got = tce.forward(tc, params_from_numpy(jp, "cpu"), torch.from_numpy(wav))
    assert got.shape == want.shape == (2, 10, 12)
    close(got, want)


def test_semantic_encoder_matches_jax():
    jp = _np(jce.init_semantic_encoder(jax.random.PRNGKey(7), 16, 8, hidden=12))
    rng = np.random.default_rng(7)
    jp["res1_b"] = rng.standard_normal(12).astype(np.float32)  # nonzero biases
    x = rng.standard_normal((2, 11, 16)).astype(np.float32)
    want = np.asarray(jce.semantic_encoder(jax.tree_util.tree_map(jnp.asarray, jp),
                                           jnp.asarray(x)))
    got = tce.semantic_encoder(params_from_numpy(jp, "cpu"), torch.from_numpy(x))
    close(got, want)


# --- the w2v-BERT semantic tower ------------------------------------------------------


@pytest.mark.parametrize("output_layer", [1, 2])
def test_semantic_tower_matches_jax(output_layer):
    kw = dict(input_dim=160, hidden=16, n_layers=2, n_heads=2, intermediate=32,
              conv_kernel=5, left_max=4, right_max=2, output_layer=output_layer)
    jc, tc = jcfg.SemanticConfig(**kw), config.SemanticConfig(**kw)
    jp = _np(jsem.init_params(jc, jax.random.PRNGKey(8)))
    feats = np.random.default_rng(8).standard_normal((2, 23, 160)).astype(np.float32)
    want = np.asarray(jsem.forward(jc, jax.tree_util.tree_map(jnp.asarray, jp),
                                   jnp.asarray(feats)))
    got = tsem.forward(tc, params_from_numpy(jp, "cpu"), torch.from_numpy(feats))
    assert got.shape == (2, 23, 16)
    close(got, want)


# --- FSQ and codec encode ----------------------------------------------------------------


def test_fsq_encode_side_matches_jax():
    levels = (4, 4, 4, 4, 4, 4, 4, 4)
    z = (np.random.default_rng(9).standard_normal((3, 50, 8)) * 2).astype(np.float32)
    jb = np.asarray(jcd.fsq_bound(jnp.asarray(z), levels))
    tb = tcd.fsq_bound(torch.from_numpy(z), levels)
    np.testing.assert_allclose(tb.numpy(), jb, atol=1e-6)
    # the quantizer on the SAME bounded latent: digits and codes equal,
    # ties included (round half to even in both)
    grid = np.concatenate([jb, np.full((3, 1, 8), 0.25, np.float32),
                           np.full((3, 1, 8), -0.75, np.float32)], axis=1)
    jd = np.asarray(jcd.fsq_quantize(jnp.asarray(grid), levels))
    td = tcd.fsq_quantize(torch.from_numpy(grid), levels)
    np.testing.assert_array_equal(td.numpy(), jd)
    np.testing.assert_array_equal(tcd.digits_to_code(td, levels).numpy(),
                                  np.asarray(jcd.digits_to_code(jnp.asarray(jd), levels)))
    np.testing.assert_array_equal(tcd.code_to_digits(tcd.digits_to_code(td, levels), levels),
                                  td)
    for a, b in zip(tcd._fsq_consts(levels, "cpu"), jcd._fsq_consts(levels)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _codec_pair(small_real: bool, seed: int):
    jc = _small_real(True) if small_real else jcfg.CODEC_TINY
    tc = _small_real(False) if small_real else config.CODEC_TINY
    jp = jcd.init_params(jc, jax.random.PRNGKey(seed))
    return jc, jp, tc, _t(jp)


@pytest.mark.parametrize("small_real", [False, True])
def test_encode_matches_jax(small_real):
    """Latent to 1e-5 and codes equal, on CODEC_TINY ("ours") and on the
    small real composition (semantic-first concatenation, 2 s and a cut
    1.3 s clip: floor(T / 320) frames)."""
    jc, jp, tc, tp = _codec_pair(small_real, 10)
    wav = _demo_wav()
    for n in (32_000, 20_999):
        w = wav[None, :n]
        sem = None
        if small_real:
            sem = tmel.semantic_features(np.pad(w[0], (160, 160)))[None]
        jsem_feats = None if sem is None else jnp.asarray(sem)
        tsem_feats = None if sem is None else torch.from_numpy(sem)
        want_z = np.asarray(jcd.encode_latent(jc, jp, jnp.asarray(w[:, : n // 320 * 320]),
                                              sem_feats=jsem_feats))
        got_z = tcd.encode_latent(tc, tp, torch.from_numpy(w[:, : n // 320 * 320]),
                                  sem_feats=tsem_feats)
        close(got_z, want_z)
        want = np.asarray(jcd.encode(jc, jp, jnp.asarray(w), sem_feats=jsem_feats))
        got = tcd.encode(tc, tp, torch.from_numpy(w), sem_feats=tsem_feats)
        assert got.dtype == torch.int32 and got.shape == (1, n // 320)
        np.testing.assert_array_equal(got.numpy(), want)
        assert len(np.unique(want)) > 1  # the codes carry information


def test_encode_without_encoder_weights_raises():
    tc = config.CODEC_TINY
    tp = tcd.init_params(tc, seed=0, device="cpu")
    with pytest.raises(ValueError, match="decoder-only"):
        tcd.encode(tc, {"dec": tp["dec"]}, torch.zeros(1, 640))
    sc = _small_real(False)
    with pytest.raises(ValueError, match="sem_feats"):
        tcd.encode(sc, tcd.init_params(sc, seed=0, device="cpu"), torch.zeros(1, 640))


@pytest.mark.parametrize("small_real", [False, True])
def test_init_params_tree_matches_jax(small_real):
    """The port's random init makes the JAX init's whole tree: every path
    (encoder and decoder), shape and dtype."""
    jc, jp, tc, _ = _codec_pair(small_real, 11)
    want = tckpt._flatten(_t(jp))
    got = tckpt._flatten(tcd.init_params(tc, seed=11, device="cpu"))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype, k


# --- encode_reference and the checkpoint ---------------------------------------------------


@pytest.fixture(scope="module", params=["tiny", "small_real"])
def cloned(request, tmp_path_factory):
    """Both pipelines from one save_pipeline checkpoint holding an encoder."""
    small_real = request.param == "small_real"
    path = tmp_path_factory.mktemp(f"ckpt_{request.param}")
    jc = _small_real(True) if small_real else jcfg.CODEC_TINY
    jckpt.save_pipeline(path, jcfg.TINY, jbb.init_params(jcfg.TINY, jax.random.PRNGKey(0)),
                        jc, jcd.init_params(jc, jax.random.PRNGKey(12)))
    j = JNeuTTS.from_checkpoint(path, g2p=JRuleG2P(), watermarker=None)
    t = NeuTTS.from_checkpoint(path, device="cpu", g2p=RuleG2P(), watermarker=None)
    return path, j, t


def test_checkpoint_carries_the_encoder(cloned):
    path, j, t = cloned
    want = tckpt._flatten(_t(j.codec_params))
    got = tckpt._flatten(t.codec_params)
    assert sorted(got) == sorted(want)
    assert any(k.startswith("enc/") for k in got)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert dataclasses.asdict(t.codec_cfg) == dataclasses.asdict(j.codec_cfg)


def test_encode_reference_matches_jax(cloned):
    _, j, t = cloned
    want = j.encode_reference(DEMO_WAV)
    got = t.encode_reference(DEMO_WAV)
    assert got.dtype == np.int32 and got.shape == (100,)
    np.testing.assert_array_equal(got, want)
    assert t.last_stats["samples"] == 32_000
