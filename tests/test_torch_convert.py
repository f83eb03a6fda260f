"""The port's backbone converters (models/convert.py, models/convert_cli.py)
and its GGUF tokenizer against the JAX package, on the same synthetic files
(tests/synthetic_ckpt.py).

Converted parameters must equal the JAX package's bit for bit (bf16 compared
as raw bits): both round float32 to bfloat16 to nearest even. Greedy tokens
from the port's converted checkpoint must equal the JAX pipeline's, and
`transformers`' generate on the source weights (the oracle of
tests/test_generate_oracle.py, top-1/top-2 margins asserted).
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from neutts_tpu import config as jcfg
from neutts_tpu.models import checkpoint as jckpt
from neutts_tpu.models import codec as jcd
from neutts_tpu.models import convert as jconvert
from neutts_tpu.pipeline import NeuTTS as JNeuTTS
from neutts_tpu.runtime import decode as jdec
from neutts_tpu.text.bpe import ByteLevelBPE as JByteLevelBPE
from neutts_tpu.text.g2p import RuleG2P as JRuleG2P
from neutts_tpu.text.tokenizer import extract_speech_codes as j_extract_speech_codes
from neutts_tpu_torch import NeuTTS, config
from neutts_tpu_torch.models import backbone as bb
from neutts_tpu_torch.models import checkpoint as tckpt
from neutts_tpu_torch.models import convert, convert_cli
from neutts_tpu_torch.runtime import decode as tdec
from neutts_tpu_torch.text.bpe import ByteLevelBPE
from neutts_tpu_torch.text.g2p import RuleG2P
from neutts_tpu_torch.text.tokenizer import HFTokenizer

from synthetic_ckpt import hf_to_gguf_tensors, make_weights, write_gguf_file, write_hf_dir
from test_generate_oracle import BASE, EOS, assert_margins, hf_generate
from test_torch_checkpoint import _assert_tree_equal, _leaves

ROOT = Path(__file__).resolve().parent.parent
# TINY's geometry with the full 65,536-code speech vocabulary, so that the
# converters' layout rule (n_text = vocab - 6 - 65,536) gives TINY's 320
CFG = config.TINY.scaled(vocab_size=320 + 6 + 65_536)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def weights():
    return make_weights(CFG, seed=3)


@pytest.fixture(scope="module")
def hf_dir(tmp_path_factory, weights):
    d = tmp_path_factory.mktemp("hf")
    write_hf_dir(d, CFG, weights)
    return d


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_from_hf_matches_jax(hf_dir, dtype):
    jc, jp = jconvert.from_hf(hf_dir, dtype=dtype)
    tc, tp = convert.from_hf(hf_dir, dtype=dtype, device="cpu")
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert tc.layout == CFG.layout and tc.n_text_tokens == 320
    assert tp["embed"].shape == (CFG.padded_vocab, CFG.hidden_size)
    assert not tp["embed"][CFG.vocab_size:].any()  # zero pad rows
    _assert_tree_equal(tp, _np_tree(jp))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("quant", [None, "Q8_0", "Q4_0"], ids=["F32", "Q8_0", "Q4_0"])
def test_from_gguf_matches_jax(tmp_path, weights, quant, dtype):
    path = write_gguf_file(tmp_path / "m.gguf", CFG, weights, quant_type=quant)
    jc, jp = jconvert.from_gguf(path, dtype=dtype)
    tc, tp = convert.from_gguf(path, dtype=dtype, device="cpu")
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert tc.tie_embeddings and "lm_head" not in tp
    _assert_tree_equal(tp, _np_tree(jp))


def test_untied_gguf_pads_the_lm_head(tmp_path, weights):
    tensors = hf_to_gguf_tensors(CFG, weights)
    tensors["output.weight"] = weights["model.embed_tokens.weight"][::-1].copy()
    convert.write_gguf(tmp_path / "u.gguf", convert.gguf_metadata(CFG), tensors)
    jc, jp = jconvert.from_gguf(tmp_path / "u.gguf", dtype="float32")
    tc, tp = convert.from_gguf(tmp_path / "u.gguf", dtype="float32", device="cpu")
    assert not tc.tie_embeddings and tp["lm_head"].shape == (CFG.hidden_size, CFG.padded_vocab)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    _assert_tree_equal(tp, _np_tree(jp))


def test_bf16_safetensors_equal_the_f32_files_conversion(tmp_path, hf_dir, weights):
    """A BF16 HF file (what the released checkpoints hold) reads through the
    pure reader; it gives what the F32 file gives in bf16. The JAX `from_hf`
    reads HF files with safe_open(framework="np"), which has no bfloat16."""
    from safetensors.torch import save_file

    bf = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in weights.items()}
    d = tmp_path / "bf16"
    d.mkdir()
    save_file(bf, str(d / "model.safetensors"))
    (d / "config.json").write_text((hf_dir / "config.json").read_text())
    _, want = convert.from_hf(hf_dir, dtype="bfloat16", device="cpu")
    _, got = convert.from_hf(d, dtype="bfloat16", device="cpu")
    for g, w in zip(tckpt.tree_leaves(got), tckpt.tree_leaves(want)):
        assert g.dtype == torch.bfloat16
        assert torch.equal(w.view(torch.int16), g.view(torch.int16))
    # and in float32: the bf16 values widened exactly
    _, wide = convert.from_hf(d, dtype="float32", device="cpu")
    torch.testing.assert_close(wide["layers"]["wq"], got["layers"]["wq"].float(), rtol=0, atol=0)


@pytest.mark.parametrize("quant", [None, "Q8_0", "Q4_0"], ids=["F32", "Q8_0", "Q4_0"])
def test_write_gguf_is_byte_identical(tmp_path, weights, quant):
    meta = {"general.architecture": "qwen2", "general.alignment": 64, "x.flag": True,
            "x.ratio": 0.5, "x.ids": [3, 1, 4], **convert.synthetic_tokenizer_metadata(
                CFG.layout)}
    tensors = hf_to_gguf_tensors(CFG, weights)
    q = None if quant is None else {n: quant for n, a in tensors.items() if a.ndim == 2}
    convert.write_gguf(tmp_path / "t.gguf", meta, tensors, align=64, quant=q)
    jconvert.write_gguf(tmp_path / "j.gguf", meta, tensors, align=64, quant=q)
    assert (tmp_path / "t.gguf").read_bytes() == (tmp_path / "j.gguf").read_bytes()
    tmeta, tt = convert.read_gguf(tmp_path / "t.gguf")
    jmeta, jt = jconvert.read_gguf(tmp_path / "t.gguf")
    assert tmeta == jmeta
    assert tt.keys() == jt.keys()
    for k in tt:
        np.testing.assert_array_equal(tt[k], jt[k], err_msg=k)


def test_q4_0_nibble_order_and_q8_0_step():
    """Q4_0: element i < 16 in the low nibble of byte i; Q8_0 dequantizes
    within half its block's f16 step."""
    x = np.linspace(-1.0, 1.0, 64, dtype=np.float32)
    q4 = convert._quant_q4_0(x)
    d = q4[:, :2].copy().view("<f2").astype(np.float32)
    nib = np.clip(np.rint(x.reshape(2, 32) / d) + 8, 0, 15).astype(np.uint8)
    np.testing.assert_array_equal(q4[:, 2:] & 0x0F, nib[:, :16])
    np.testing.assert_array_equal(q4[:, 2:] >> 4, nib[:, 16:])
    y = np.random.default_rng(0).standard_normal(4096).astype(np.float32)
    q8 = convert._quant_q8_0(y)
    back = convert._dequant_q8_0(q8.reshape(-1), y.size)
    step = q8[:, :2].copy().view("<f2").astype(np.float32)
    assert (np.abs(back - y).reshape(-1, 32) <= 0.5 * step * (1 + 2**-10)).all()


def test_gguf_tokenizer_matches_jax(tmp_path, weights):
    meta = convert.synthetic_tokenizer_metadata(CFG.layout)
    path = tmp_path / "tok.gguf"
    convert.write_gguf(path, meta, {"output_norm.weight": weights["model.norm.weight"]})
    ours = ByteLevelBPE.from_gguf(path)
    ref = JByteLevelBPE.from_gguf(path)
    same = ByteLevelBPE.from_gguf_metadata(meta)
    lay = CFG.layout
    for text in ["hello world", "the quick brown fox, 42 times!",
                 f"<|speech_7|>ok{config.SPECIAL_TOKEN_NAMES[2]} zz", ""]:
        assert ours.encode(text) == ref.encode(text) == same.encode(text)
    tok = HFTokenizer(str(path))
    assert tok.layout == lay
    assert tok.convert_token_to_id("<|speech_0|>") == lay.speech_base
    assert tok.convert_token_to_id("<|SPEECH_GENERATION_END|>") == lay.speech_gen_end


def test_writers_invert_the_readers(hf_dir, weights):
    """`to_hf_tensors` of the converted tree gives back the HF file's
    tensors, and `hf_to_gguf_tensors` names them as tests/synthetic_ckpt.py
    (the JAX side's GGUF files) does."""
    _, params = convert.from_hf(hf_dir, dtype="float32", device="cpu")
    back = convert.to_hf_tensors(CFG, params)
    assert back.keys() == weights.keys()
    for k, v in back.items():
        np.testing.assert_array_equal(v.numpy(), weights[k], err_msg=k)
    ours, theirs = convert.hf_to_gguf_tensors(CFG, weights), hf_to_gguf_tensors(CFG, weights)
    assert ours.keys() == theirs.keys()
    assert all(ours[k] is theirs[k] for k in ours)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_write_hf_dir_round_trips(tmp_path, dtype):
    """The port's tree, untied head included, through write_hf_dir and
    from_hf: the same bits, the same geometry."""
    cfg = CFG.scaled(tie_embeddings=False, dtype=dtype)
    params = bb.init_params(cfg, seed=5, device="cpu")
    params["embed"][cfg.vocab_size:] = 0  # from_hf pads with zeros
    params["lm_head"][:, cfg.vocab_size:] = 0
    convert.write_hf_dir(tmp_path, cfg, params)
    got_cfg, got = convert.from_hf(tmp_path, dtype=dtype, device="cpu")
    assert got_cfg == cfg.scaled(name=tmp_path.name, max_context=2048, dtype="bfloat16")
    got, params = dict(_leaves(got)), dict(_leaves(params))
    assert got.keys() == params.keys()
    for k, w in params.items():
        assert got[k].dtype == w.dtype and torch.equal(got[k], w), k


def test_gguf_metadata_reads_back(tmp_path, weights):
    """gguf_metadata gives config_from_gguf the geometry and the GGUF
    tokenizer the layout; read_gguf_metadata reads it without the tensors."""
    path = write_gguf_file(tmp_path / "m.gguf", CFG, weights)
    meta = convert.gguf_metadata(CFG)
    convert.write_gguf(tmp_path / "w.gguf", meta, convert.hf_to_gguf_tensors(CFG, weights))
    cfg, _ = convert.from_gguf(tmp_path / "w.gguf", dtype="float32", device="cpu")
    want = CFG.scaled(name="w", max_context=2048, dtype="bfloat16")
    assert dataclasses.replace(cfg, rms_norm_eps=want.rms_norm_eps) == want
    assert cfg.rms_norm_eps == float(np.float32(want.rms_norm_eps))  # stored as f32
    assert HFTokenizer(str(tmp_path / "w.gguf")).layout == CFG.layout
    for f in (path, tmp_path / "w.gguf"):
        assert convert.read_gguf_metadata(f) == convert.read_gguf(f)[0]


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory, hf_dir):
    """The same HF directory through each package's converter into an npz
    checkpoint (f32, the TINY codec of the JAX package)."""
    jdir = tmp_path_factory.mktemp("jax_ckpt")
    jc, jp = jconvert.from_hf(hf_dir, dtype="float32")
    jckpt.save_pipeline(jdir, jc, jp, jcfg.CODEC_TINY,
                        jcd.init_params(jcfg.CODEC_TINY, jax.random.PRNGKey(1)))
    tdir = tmp_path_factory.mktemp("port_ckpt")
    convert_cli.main(["--hf", str(hf_dir), "--codec", str(jdir), "--dtype", "float32",
                      "--out", str(tdir)])
    return jdir, tdir


def test_convert_cli_checkpoint_equals_jax_conversion(checkpoints):
    jdir, tdir = checkpoints
    jb, jparams, jc, jcp = jckpt.load_pipeline(jdir)
    tb, tparams, tc, tcp = tckpt.load_pipeline(tdir, device="cpu")
    assert jb.dtype == "bfloat16" and tb.dtype == "float32"  # the weights' dtype
    assert dataclasses.asdict(tb) == dataclasses.asdict(jb.scaled(dtype="float32"))
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    _assert_tree_equal(tparams, _np_tree(jparams))
    _assert_tree_equal(tcp, _np_tree(jcp))


def test_convert_cli_runs_as_a_module(tmp_path, hf_dir, checkpoints):
    jdir, _ = checkpoints
    r = subprocess.run(
        [sys.executable, "-m", "neutts_tpu_torch.models.convert_cli", "--hf", str(hf_dir),
         "--codec", str(jdir), "--out", str(tmp_path / "c")],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    b, p, _, _ = tckpt.load_pipeline(tmp_path / "c", device="cpu")
    assert p["layers"]["wq"].dtype == torch.bfloat16 and b.n_layers == CFG.n_layers


def test_greedy_infer_from_converted_checkpoint_matches_jax(checkpoints):
    """convert_cli's output, loaded by load_pipeline, against the JAX
    pipeline on its own conversion: the same speech codes under greedy
    decoding, waveforms to 1e-5 (f32 codec in both)."""
    jdir, tdir = checkpoints
    greedy = dict(greedy=True, min_new_tokens=8)
    jb, jparams, jc, jcp = jckpt.load_pipeline(jdir)
    j = JNeuTTS(jb.scaled(max_context=256, dtype="float32"), jparams, jc, jcp, g2p=JRuleG2P(),
                watermarker=None, sampling=jcfg.SamplingConfig(**greedy))
    tb, tparams, tc, tcp = tckpt.load_pipeline(tdir, device="cpu")
    t = NeuTTS(tb.scaled(max_context=256), tparams, tc, tcp, device="cpu", g2p=RuleG2P(),
               watermarker=None, sampling=config.SamplingConfig(**greedy))
    assert t.max_context == 256
    ref = np.random.default_rng(0).integers(0, 64, size=24).astype(np.int32)
    texts, refs = ["Hello there, a converted model.", "Short one."], [ref, ref[:10]]
    got = t.infer_batch(texts, refs, ["So I'm live on radio."] * 2)
    want = j.infer_batch(texts, refs, ["So I'm live on radio."] * 2)
    prompts = [j._build_prompt(x, r, "So I'm live on radio.") for x, r in zip(texts, refs)]
    toks, lens = jdec.pad_prompts(prompts, pad_id=getattr(j.tokenizer, "pad_id", 0),
                                  bucket=t.last_stats["bucket"])
    res = jdec.generate(j.backbone_cfg, j.sampling, j._eos, 256 - 1, j.backbone_params,
                        toks, lens, jax.random.PRNGKey(0))
    for i, (g, w) in enumerate(zip(got, want)):
        codes = j_extract_speech_codes(jdec.extract(res, i, j._eos), jb.layout)
        assert t.last_stats["codes"][i] == codes and len(codes) > 0
        assert g.shape == w.shape == (len(codes) * 480,)
        np.testing.assert_allclose(g, w, atol=1e-5)


@pytest.mark.parametrize("source", ["hf", "gguf"])
def test_converted_generate_matches_transformers(tmp_path, source):
    """Greedy decode of the port on converted weights equals `transformers`
    generate on the source weights (test_generate_oracle.py's fixture:
    seed 14, f32, margins asserted)."""
    pytest.importorskip("transformers")
    from synthetic_ckpt import build_hf_model

    w = make_weights(BASE, seed=14)
    if source == "hf":
        write_hf_dir(tmp_path, BASE, w)
        cfg, params = convert.from_hf(tmp_path, dtype="float32", device="cpu")
    else:
        path = write_gguf_file(tmp_path / "m.gguf", BASE, w)
        cfg, params = convert.from_gguf(path, dtype="float32", device="cpu")
    cfg = cfg.scaled(max_context=BASE.max_context, kv_dtype="float32", dtype="float32")
    prompt = np.random.default_rng(0).integers(1, cfg.vocab_size, size=21).tolist()
    want, gaps = hf_generate(build_hf_model(BASE, w), prompt, max_new=120)
    assert_margins(gaps, len(want))
    toks, lens = tdec.pad_prompts([prompt], pad_id=0, device="cpu")
    res = tdec.generate(cfg, config.SamplingConfig(greedy=True, min_new_tokens=1), EOS, 120,
                        params, toks, lens)
    assert tdec.extract(res, 0, EOS) == [t for t in want if t != EOS]
