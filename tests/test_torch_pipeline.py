"""End-to-end: the port's NeuTTS.infer_batch against the JAX pipeline from
one checkpoint, under greedy decoding (the two packages' random streams
differ, so only greedy runs can match token for token).

Same prompt ids, same generated tokens, and waveforms equal to 1e-5 (f32
codec in both; summation order only).
"""

import jax
import numpy as np
import pytest
import torch

from neutts_tpu import config as jcfg
from neutts_tpu.models import backbone as jbb
from neutts_tpu.models import checkpoint as jckpt
from neutts_tpu.models import codec as jcd
from neutts_tpu.pipeline import NeuTTS as JNeuTTS
from neutts_tpu.text.g2p import RuleG2P as JRuleG2P
from neutts_tpu_torch import NeuTTS, config
from neutts_tpu_torch.runtime import decode as tdec
from neutts_tpu_torch.text.g2p import RuleG2P

REF_TEXT = "So I'm live on radio."
TEXTS = ["Hello there, this is a test.", "Short one."]


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    path = tmp_path_factory.mktemp("ckpt")
    cfg = jcfg.TINY.scaled(max_context=224)  # short decode budget for test speed
    jckpt.save_pipeline(path, cfg, jbb.init_params(cfg, jax.random.PRNGKey(0)),
                        jcfg.CODEC_TINY, jcd.init_params(jcfg.CODEC_TINY, jax.random.PRNGKey(1)))
    j = JNeuTTS.from_checkpoint(path, g2p=JRuleG2P(),
                                sampling=jcfg.SamplingConfig(greedy=True, min_new_tokens=8))
    t = NeuTTS.from_checkpoint(path, device="cpu", g2p=RuleG2P(),
                               sampling=config.SamplingConfig(greedy=True, min_new_tokens=8))
    return j, t


@pytest.fixture(scope="module")
def ref_codes():
    return np.random.default_rng(0).integers(0, 64, size=24).astype(np.int32)


def test_prompt_ids_match(pair, ref_codes):
    j, t = pair
    for text in TEXTS:
        assert t._build_prompt(text, ref_codes, REF_TEXT) == j._build_prompt(
            text, ref_codes, REF_TEXT)


def test_infer_batch_matches_jax(pair, ref_codes):
    j, t = pair
    refs = [ref_codes, ref_codes[:10]]
    want = j.infer_batch(TEXTS, refs, [REF_TEXT] * 2)
    got = t.infer_batch(TEXTS, refs, [REF_TEXT] * 2)
    stats = t.last_stats
    assert len(got) == 2
    for g, w, n in zip(got, want, stats["n_codes"]):
        assert g.dtype == np.float32 and np.isfinite(g).all()
        assert g.shape == w.shape == (n * 480,)
        np.testing.assert_allclose(g, w, atol=1e-5)


def test_generated_tokens_match(pair, ref_codes):
    """Token-for-token, on the pipeline's own prompts and bucket."""
    import jax.numpy as jnp  # noqa: F401  (jax arrays are read through np.asarray)
    from neutts_tpu.runtime import decode as jdec

    j, t = pair
    prompts = [t._build_prompt(x, ref_codes, REF_TEXT) for x in TEXTS]
    bucket = t._pick_bucket(max(map(len, prompts)))
    assert bucket == j._pick_bucket(max(map(len, prompts)))
    jt, jl = jdec.pad_prompts(prompts, pad_id=256, bucket=bucket)
    tt, tl = tdec.pad_prompts(prompts, pad_id=256, bucket=bucket, device="cpu")
    eos = t._eos
    jr = jdec.generate(j.backbone_cfg, j.sampling, eos, 64, j.backbone_params, jt, jl,
                       jax.random.PRNGKey(0))
    tr = tdec.generate(t.backbone_cfg, t.sampling, eos, 64, t.backbone_params, tt, tl)
    np.testing.assert_array_equal(tr.tokens.numpy(), np.asarray(jr.tokens))
    np.testing.assert_array_equal(tr.lengths.numpy(), np.asarray(jr.lengths))


def test_infer_accepts_torch_tensor_codes(pair, ref_codes):
    _, t = pair
    a = t._build_prompt(TEXTS[1], torch.from_numpy(ref_codes), REF_TEXT)
    assert a == t._build_prompt(TEXTS[1], ref_codes, REF_TEXT)
