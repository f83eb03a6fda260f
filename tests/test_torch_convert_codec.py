"""The port's codec converter (models/convert_codec.py) and the semantic
tower's HF mapping (models/semantic.py `from_hf_state_dict`) against the
JAX package, on the artifacts tests/test_convert_codec.py and
tests/test_codecenc.py build: a decoder-only state dict as .pt,
.safetensors (F32 and BF16) and an ONNX decoder (float and bfloat16
initializers), and full state dicts with the w2v-BERT tower, a semantic
projection, fc_prior and an acoustic branch (the JAX package's canonical
`enc.*` layout and the real `CodecEnc.*` layout).

Converted trees must equal the JAX package's exactly. Decode matches it to
atol 5e-5 / rtol 1e-4 and encode to 2e-4 / 1e-3, the tolerances the JAX
package holds itself to against its torch oracles. Every refusal of the JAX
mapper is a refusal here, with the same message.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn

from neutts_tpu import config as jcfg
from neutts_tpu.models import codec as jcd
from neutts_tpu.models import convert_codec as jcc
from neutts_tpu.models import semantic as jsem
from neutts_tpu_torch import config
from neutts_tpu_torch.models import checkpoint as tckpt
from neutts_tpu_torch.models import codec as tcd
from neutts_tpu_torch.models import convert_codec as tcc
from neutts_tpu_torch.models import semantic as tsem

from test_codecenc import TorchCodecEncoder, TorchSemanticEncoder
from test_convert_codec import H, HOP, VQ, TorchCodecModel
from test_torch_checkpoint import _assert_tree_equal

DECODE_TOL = dict(atol=5e-5, rtol=1e-4)
ENCODE_TOL = dict(atol=2e-4, rtol=1e-3)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _numpy_sd(module):
    return {k: v.detach().numpy() for k, v in module.state_dict().items()}


def _decoder_sd(seed=0, convnext=False):
    torch.manual_seed(seed)
    return _numpy_sd(TorchCodecModel(rope=not convnext, convnext=convnext).eval())


def _assert_converted_equal(tcfg, tparams, jcfg_, jparams):
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg_)
    if jparams["enc"] is None:
        assert tparams["enc"] is None
        _assert_tree_equal(tparams["dec"], _np_tree(jparams["dec"]))
    else:
        _assert_tree_equal(tparams, _np_tree(jparams))


def _assert_decode_matches(tcfg, tparams, jcfg_, jparams, n=13):
    codes = np.random.default_rng(1).integers(0, 65_536, size=(2, n))
    want = np.asarray(jcd.decode(jcfg_, jparams, jnp.asarray(codes, jnp.int32)))
    got = tcd.decode(tcfg, tparams, torch.from_numpy(codes)).numpy()
    assert got.shape == want.shape == (2, n * HOP)
    np.testing.assert_allclose(got, want, **DECODE_TOL)


@pytest.mark.parametrize("convnext", [False, True], ids=["transformer", "convnext"])
def test_map_decoder_state_dict_matches_jax(convnext):
    sd = _decoder_sd(convnext=convnext)
    t = tcc.map_decoder_state_dict(sd, heads=H)
    j = jcc.map_decoder_state_dict(sd, heads=H)
    assert t.cfg_kwargs == j.cfg_kwargs and t.unmapped == j.unmapped
    _assert_tree_equal(tckpt.params_from_numpy(t.params, "cpu"), j.params)


# --- artifact formats ------------------------------------------------------------


def _vint(n):
    out = b""
    while True:
        b7, n = n & 0x7F, n >> 7
        out += bytes([b7 | (0x80 if n else 0)])
        if not n:
            return out


def _fld(no, wire, payload):
    if wire == 2:
        return _vint((no << 3) | 2) + _vint(len(payload)) + payload
    return _vint(no << 3) + _vint(payload)


def _write_onnx(path, sd, bf16=False):
    """A ModelProto whose graph holds `sd` as initializers (raw data, float
    or bfloat16) and one Identity node."""
    graph = _fld(1, 2, _fld(1, 2, b"codes") + _fld(2, 2, b"wav") + _fld(4, 2, b"Identity"))
    for name, arr in sd.items():
        msg = b"".join(_fld(1, 0, d) for d in arr.shape)
        if bf16:
            bits = torch.from_numpy(np.ascontiguousarray(arr, np.float32)).to(torch.bfloat16)
            msg += _fld(2, 0, 16) + _fld(8, 2, name.encode())
            msg += _fld(9, 2, bits.view(torch.int16).numpy().tobytes())
        else:
            msg += _fld(2, 0, 1) + _fld(8, 2, name.encode())
            msg += _fld(9, 2, np.ascontiguousarray(arr, "<f4").tobytes())
        graph += _fld(5, 2, msg)
    graph += _fld(11, 2, _fld(1, 2, b"codes")) + _fld(12, 2, _fld(1, 2, b"wav"))
    path.write_bytes(_fld(1, 0, 8) + _fld(7, 2, graph))


@pytest.mark.parametrize("fmt", ["pt", "safetensors", "safetensors_bf16", "onnx", "onnx_bf16"])
def test_convert_codec_artifact_matches_jax(tmp_path, fmt):
    sd = _decoder_sd(seed=5)
    if fmt == "pt":
        path = tmp_path / "neucodec.pt"
        torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    elif fmt.startswith("safetensors"):
        from safetensors.torch import save_file

        dt = torch.bfloat16 if fmt.endswith("bf16") else torch.float32
        path = tmp_path / "neucodec.safetensors"
        save_file({k: torch.from_numpy(v).to(dt) for k, v in sd.items()}, str(path))
    else:
        path = tmp_path / "decoder.onnx"
        _write_onnx(path, sd, bf16=fmt.endswith("bf16"))
    tcfg, tparams = tcc.convert_codec(path, heads=H, device="cpu")
    jcfg_, jparams = jcc.convert_codec(path, heads=H)
    assert tparams["enc"] is None
    _assert_converted_equal(tcfg, tparams, jcfg_, jparams)
    _assert_decode_matches(tcfg, tparams, jcfg_, jparams)


def test_read_onnx_matches_jax(tmp_path):
    sd = _decoder_sd(seed=6)
    _write_onnx(tmp_path / "d.onnx", sd)
    t, j = tcc.read_onnx(tmp_path / "d.onnx"), jcc.read_onnx(tmp_path / "d.onnx")
    assert t.graph_inputs == j.graph_inputs == ["codes"] and t.graph_outputs == ["wav"]
    assert [(n.op_type, n.inputs, n.outputs) for n in t.nodes] == [
        (n.op_type, n.inputs, n.outputs) for n in j.nodes]
    assert t.initializers.keys() == j.initializers.keys() == sd.keys()
    for k, v in sd.items():
        np.testing.assert_array_equal(t.initializers[k], v)


def test_save_converted_round_trips(tmp_path):
    path = tmp_path / "neucodec.pt"
    torch.save({k: torch.from_numpy(v) for k, v in _decoder_sd(seed=7).items()}, path)
    cfg, params = tcc.convert_codec(path, heads=H, device="cpu")
    tcc.save_converted(tmp_path / "out", cfg, params)
    back = tckpt.load_params(tmp_path / "out" / "codec.npz", device="cpu")
    assert set(back) == {"dec"}
    _assert_tree_equal(back["dec"], tckpt.tree_map(lambda x: x.numpy(), params["dec"]))


# --- full state dicts: the encoder side ----------------------------------------------


def _wav2vec2bert(seed, left=64, right=8):
    from transformers import Wav2Vec2BertConfig, Wav2Vec2BertModel

    hf = Wav2Vec2BertConfig(
        hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
        intermediate_size=64, feature_projection_input_dim=12,
        conv_depthwise_kernel_size=7, left_max_position_embeddings=left,
        right_max_position_embeddings=right, hidden_dropout=0.0,
        attention_dropout=0.0, activation_dropout=0.0, feat_proj_dropout=0.0,
        conformer_conv_dropout=0.0, apply_spec_augment=False,
    )
    torch.manual_seed(seed)
    return Wav2Vec2BertModel(hf).eval()


def _ours_layout_sd():
    """tests/test_convert_codec.py's full state dict: tower, sem_proj,
    fc_prior, the decoder and the JAX package's `enc.*` acoustic layout."""
    tower = _wav2vec2bert(1)
    sem_proj = nn.Linear(32, 24)
    acfg = jcfg.CodecConfig()  # the converter's default "ours" geometry
    ap = tckpt.tree_map(lambda x: x.numpy(),
                        tcd.init_params(config.CodecConfig(), seed=2, device="cpu")["enc"])
    fc_prior = nn.Linear(acfg.enc_hidden + 24, VQ)
    sd = {f"semantic_model.{k}": v for k, v in _numpy_sd(tower).items()}
    sd.update({f"sem_proj.{k}": v for k, v in _numpy_sd(sem_proj).items()})
    sd.update({f"fc_prior.{k}": v for k, v in _numpy_sd(fc_prior).items()})
    sd.update(_decoder_sd(seed=8))
    sd["enc.stem_w"], sd["enc.stem_b"] = ap["stem_w"], ap["stem_b"]
    for i, st in enumerate(ap["stages"]):
        for k, v in st.items():
            sd[f"enc.stages.{i}.{k}"] = v
    for k in ("post_w", "post_b", "project_in_w", "project_in_b"):
        sd[f"enc.{k}"] = ap[k]
    return sd, 3200


def _real_layout_sd():
    """tests/test_codecenc.py's real-layout state dict: `CodecEnc.*`,
    `SemanticEncoder_module.*`, `semantic_model.*`, fc_prior, fc_post_s, the
    quantizer's project_in and the decoder."""
    tower = _wav2vec2bert(5)
    torch.manual_seed(5)
    sem_enc = TorchSemanticEncoder(32, 24, 16).eval()
    acoustic = TorchCodecEncoder(ngf=4, up_ratios=(2, 4, 5), dilations=(1, 3),
                                 out_channels=24, rnn_layers=1, alias_free=True).eval()
    sd = _decoder_sd(seed=9)
    sd.update({f"semantic_model.{k}": v for k, v in _numpy_sd(tower).items()})
    sd.update({f"SemanticEncoder_module.{k}": v for k, v in _numpy_sd(sem_enc).items()})
    sd.update({f"CodecEnc.{k}": v for k, v in _numpy_sd(acoustic).items()})
    sd.update({f"fc_prior.{k}": v for k, v in _numpy_sd(nn.Linear(48, VQ)).items()})
    sd.update({f"fc_post_s.{k}": v for k, v in _numpy_sd(nn.Linear(VQ, 32)).items()})
    sd.update({f"generator.quantizer.layers.0.project_in.{k}": v
               for k, v in _numpy_sd(nn.Linear(VQ, 8)).items()})
    return sd, 400


@pytest.mark.parametrize("layout", ["ours", "real"])
def test_full_state_dict_converts_like_jax(tmp_path, layout):
    pytest.importorskip("transformers")
    sd, n_samples = _ours_layout_sd() if layout == "ours" else _real_layout_sd()
    path = tmp_path / "full_codec.pt"
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}, path)
    tcfg, tparams = tcc.convert_codec(path, heads=H, semantic_output_layer=2, device="cpu")
    jcfg_, jparams = jcc.convert_codec(path, heads=H, semantic_output_layer=2)
    assert tparams["enc"] is not None and tcfg.semantic.output_layer == 2
    _assert_converted_equal(tcfg, tparams, jcfg_, jparams)
    jparams = jax.tree_util.tree_map(jnp.asarray, jparams)
    _assert_decode_matches(tcfg, tparams, jcfg_, jparams)

    rng = np.random.default_rng(3)
    wav = (rng.standard_normal((1, n_samples)) * 0.1).astype(np.float32)
    feats = rng.standard_normal((1, n_samples // tcfg.hop_in, 12)).astype(np.float32)
    want = np.asarray(jcd.encode_features(jcfg_, jparams, jnp.asarray(wav),
                                          sem_feats=jnp.asarray(feats)))
    got = tcd.encode_features(tcfg, tparams, torch.from_numpy(wav),
                              sem_feats=torch.from_numpy(feats)).numpy()
    np.testing.assert_allclose(got, want, **ENCODE_TOL)
    if layout == "ours":  # its project_in is the JAX init's, not sized for this decoder
        return
    want = np.asarray(jcd.encode_latent(jcfg_, jparams, jnp.asarray(wav),
                                        sem_feats=jnp.asarray(feats)))
    got = tcd.encode_latent(tcfg, tparams, torch.from_numpy(wav),
                            sem_feats=torch.from_numpy(feats)).numpy()
    np.testing.assert_allclose(got, want, **ENCODE_TOL)


def test_semantic_from_hf_state_dict_matches_jax_and_hf():
    """The tower's mapping equals the JAX mapping, and its forward matches
    transformers' Wav2Vec2BertModel (tests/test_semantic.py's tolerances)."""
    pytest.importorskip("transformers")
    m = _wav2vec2bert(0, left=8, right=4)
    sd = _numpy_sd(m)
    tcfg, tparams = tsem.from_hf_state_dict(sd, left_max=8, right_max=4, device="cpu")
    jcfg_, jparams = jsem.from_hf_state_dict(sd, left_max=8, right_max=4)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg_)
    assert (tcfg.left_max, tcfg.right_max) == (8, 4)
    _assert_tree_equal(tparams, _np_tree(jparams))
    # the default split (right 8, the rest left) as in JAX
    big = _numpy_sd(_wav2vec2bert(0))
    assert (tsem.from_hf_state_dict(big, device="cpu")[0].left_max,
            tsem.from_hf_state_dict(big, device="cpu")[0].right_max) == (64, 8)

    feats = np.random.default_rng(0).standard_normal((2, 24, 12)).astype(np.float32)
    with torch.no_grad():
        out = m(input_features=torch.from_numpy(feats), output_hidden_states=True)
    for layer, want in ((tcfg.n_layers, out.last_hidden_state), (1, out.hidden_states[1])):
        cfg = dataclasses.replace(tcfg, output_layer=layer)
        got = tsem.forward(cfg, tparams, torch.from_numpy(feats)).numpy()
        np.testing.assert_allclose(got, want.numpy(), atol=2e-5, rtol=1e-4)


# --- refusals -----------------------------------------------------------------------


def _refusal_unmapped_key():
    sd = _decoder_sd(seed=3)
    sd["generator.backbone.mystery_gate.weight"] = np.zeros((3, 3), np.float32)
    return lambda cc: cc.map_decoder_state_dict(sd, heads=H), "mystery_gate"


def _codecenc_sd(seed):
    torch.manual_seed(seed)
    m = TorchCodecEncoder(alias_free=True).eval()
    return {f"CodecEnc.{k}": v.numpy().copy() for k, v in m.state_dict().items()}


def _refusal_linear_scale_snake():
    sd = _codecenc_sd(4)
    for k in sd:
        if k.endswith((".alpha", ".beta")):
            sd[k] = np.ones_like(sd[k])  # alpha_logscale=False initialisation
    return lambda cc: cc._map_codecenc(sd), "SnakeBeta alpha values cluster"


def _refusal_bad_filter():
    sd = _codecenc_sd(4)
    bad = next(k for k in sd if k.endswith("upsample.filter"))
    sd[bad] = sd[bad] + 0.05
    return lambda cc: cc._map_codecenc(sd), "anti-aliasing filter"


def _refusal_no_acoustic_branch():
    sd = {f"semantic_model.{k}": v for k, v in _numpy_sd(_wav2vec2bert(1)).items()}
    sd.update({f"sem_proj.{k}": v for k, v in _numpy_sd(nn.Linear(32, 24)).items()})
    sd.update({f"fc_prior.{k}": v for k, v in _numpy_sd(nn.Linear(40, VQ)).items()})
    return lambda cc: cc.map_encoder_state_dict(sd), "needs the acoustic branch"


@pytest.mark.parametrize("case", [_refusal_unmapped_key, _refusal_linear_scale_snake,
                                  _refusal_bad_filter, _refusal_no_acoustic_branch],
                         ids=["unmapped_key", "snake_log_scale", "filter", "no_acoustic"])
def test_refusals_match_jax(case):
    if case is _refusal_no_acoustic_branch:
        pytest.importorskip("transformers")
    call, match = case()
    with pytest.raises(ValueError, match=match) as t:
        call(tcc)
    with pytest.raises(ValueError) as j:
        call(jcc)
    assert str(t.value) == str(j.value)
