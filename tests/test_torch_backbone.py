"""Port backbone, sampling and generate (neutts_tpu_torch) against the JAX
package on TINY, with the JAX weights handed to the port through
`params_from_numpy`.

Tolerances: f32 weights with an f32 or int8 cache run the same f32 math in
another summation order — 2e-4 on the logits (as tests/test_backbone.py
allows between two JAX paths). int8 weights differ only where an activation
lands within an ulp of an int8 rounding boundary — within one quantization
step, bounded at 3e-2 of the logit range. Greedy tokens must match exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neutts_tpu import config as jcfg
from neutts_tpu.models import backbone as jbb
from neutts_tpu.ops import sampling as jsmp
from neutts_tpu.runtime import decode as jdec
from neutts_tpu_torch import config
from neutts_tpu_torch.models import backbone as tbb
from neutts_tpu_torch.models.checkpoint import params_from_numpy
from neutts_tpu_torch.ops import sampling as tsmp
from neutts_tpu_torch.runtime import decode as tdec

CFG = config.TINY
JCFG = jcfg.TINY
EOS = CFG.layout.speech_gen_end


@pytest.fixture(scope="module")
def jparams():
    return jbb.init_params(JCFG, jax.random.PRNGKey(0), dtype=jnp.float32)


def _to_torch(jtree):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, jtree), "cpu")


def _run_both(jparams, kv_dtype, quant, n_steps=4):
    """Prefill two ragged left-padded prompts, then n_steps decode steps, in
    both packages on the same weights; returns the logits lists and caches."""
    jc = JCFG.scaled(kv_dtype=kv_dtype)
    tc = CFG.scaled(kv_dtype=kv_dtype)
    jp = jbb.quantize_params(jparams) if quant else jparams
    tp = _to_torch(jp)
    prompts = [[5, 6, 7, 8, 9, 10, 11], [12, 13, 14]]
    jt, jl = jdec.pad_prompts(prompts, pad_id=0, bucket=16)
    tt, tl = tdec.pad_prompts(prompts, pad_id=0, bucket=16, device="cpu")
    jcache = jbb.KVCache.create(jc, 2, max_len=32, dtype=jnp.float32)
    tcache = tbb.KVCache.create(tc, 2, max_len=32, device="cpu", dtype=torch.float32)
    jlog, jcache = jbb.prefill(jc, jp, jt, jl, jcache)
    tlog, tcache = tbb.prefill(tc, tp, tt, tl, tcache)
    jout, tout = [np.asarray(jlog)], [tlog.numpy()]
    pad_j = (16 - jl).astype(jnp.int32)
    pad_t = (16 - tl).to(torch.int32)
    for s in range(n_steps):
        tok = [20 + s, 30 + s]
        jlog, jcache = jbb.decode_step(jc, jp, jnp.asarray(tok, jnp.int32), jcache,
                                       jnp.int32(16 + s), pad_j)
        tlog, tcache = tbb.decode_step(tc, tp, torch.tensor(tok, dtype=torch.int32), tcache,
                                       16 + s, pad_t)
        jout.append(np.asarray(jlog))
        tout.append(tlog.numpy())
    return jout, tout, jcache, tcache, np.asarray(pad_j)


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
def test_prefill_decode_logits_f32_weights(jparams, kv_dtype):
    jout, tout, jcache, tcache, pad = _run_both(jparams, kv_dtype, quant=False)
    for a, b in zip(tout, jout):
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-4)
    # the caches match on every real slot (pad slots hold garbage in JAX,
    # values of the zeroed pad rows in the port; both are masked)
    for b in range(2):
        sl = slice(int(pad[b]), 20)
        np.testing.assert_allclose(tcache.k[:, b, sl].float().numpy(),
                                   np.asarray(jcache.k[:, b, sl], np.float32),
                                   rtol=2e-4, atol=2e-4 if kv_dtype == "float32" else 1.0)
        if kv_dtype == "int8":
            np.testing.assert_allclose(tcache.k_scale[:, b, sl].numpy(),
                                       np.asarray(jcache.k_scale[:, b, sl]), rtol=1e-4)


def test_prefill_decode_logits_int8_weights(jparams):
    jout, tout, *_ = _run_both(jparams, "int8", quant=True)
    for a, b in zip(tout, jout):
        assert np.max(np.abs(a - b)) <= 3e-2 * np.max(np.abs(b))


def test_quantize_params_tree_matches(jparams):
    jq = jax.tree_util.tree_map(np.asarray, jbb.quantize_params(jparams))
    tq = tbb.quantize_params(_to_torch(jparams))
    assert set(tq["layers"]) == set(jq["layers"])
    np.testing.assert_array_equal(tq["layers"]["wqkv"]["q"].numpy(), jq["layers"]["wqkv"]["q"])
    np.testing.assert_array_equal(tq["lm_head"]["q"].numpy(), jq["lm_head"]["q"])
    np.testing.assert_allclose(tq["layers"]["wqkv"]["b"].numpy(), jq["layers"]["wqkv"]["b"])


@pytest.mark.parametrize("kv_dtype,quant", [("float32", False), ("int8", False), ("int8", True)])
def test_greedy_generate_matches_jax(jparams, kv_dtype, quant):
    """Greedy generate: identical tokens and lengths, ragged prompts."""
    jc = JCFG.scaled(kv_dtype=kv_dtype)
    tc = CFG.scaled(kv_dtype=kv_dtype)
    jp = jbb.quantize_params(jparams) if quant else jparams
    scfg_j = jcfg.SamplingConfig(greedy=True, min_new_tokens=3)
    scfg_t = config.SamplingConfig(greedy=True, min_new_tokens=3)
    prompts = [[3, 1, 4, 1, 5, 9, 2, 6], [2, 7, 1, 8]]
    jt, jl = jdec.pad_prompts(prompts, pad_id=0, bucket=16)
    tt, tl = tdec.pad_prompts(prompts, pad_id=0, bucket=16, device="cpu")
    jr = jdec.generate(jc, scfg_j, EOS, 12, jp, jt, jl, jax.random.PRNGKey(0))
    tr = tdec.generate(tc, scfg_t, EOS, 12, _to_torch(jp), tt, tl)
    np.testing.assert_array_equal(tr.tokens.numpy(), np.asarray(jr.tokens))
    np.testing.assert_array_equal(tr.lengths.numpy(), np.asarray(jr.lengths))
    for i in range(2):
        assert tdec.extract(tr, i, EOS) == jdec.extract(jr, i, EOS)


def test_generate_per_row_context_cap(jparams):
    """Rows stop at max_context real tokens (left pad excluded), EOS-filled."""
    tc = CFG.scaled(max_context=20)
    jc = JCFG.scaled(max_context=20)
    scfg = dict(greedy=True, min_new_tokens=30)
    prompts = [[3, 1, 4, 1, 5, 9, 2, 6, 5, 3], [2, 7]]
    jt, jl = jdec.pad_prompts(prompts, pad_id=0, bucket=16)
    tt, tl = tdec.pad_prompts(prompts, pad_id=0, bucket=16, device="cpu")
    jr = jdec.generate(jc, jcfg.SamplingConfig(**scfg), EOS, 19, jparams, jt, jl,
                       jax.random.PRNGKey(0))
    tr = tdec.generate(tc, config.SamplingConfig(**scfg), EOS, 19, _to_torch(jparams), tt, tl)
    np.testing.assert_array_equal(tr.tokens.numpy(), np.asarray(jr.tokens))
    np.testing.assert_array_equal(tr.lengths.numpy(), np.asarray(jr.lengths))
    assert tr.lengths.tolist() == [11, 19]  # incl. the closing EOS


def test_int4_and_auto_not_ported_yet(jparams):
    tt, tl = tdec.pad_prompts([[1, 2, 3]], pad_id=0, bucket=16, device="cpu")
    for kv in ("int4", "auto"):
        with pytest.raises(NotImplementedError):
            tdec.generate(CFG.scaled(kv_dtype=kv), config.SamplingConfig(greedy=True), EOS, 4,
                          _to_torch(jparams), tt, tl)


def test_rope_is_half_split():
    """Backbone RoPE rotates pairs (i, i + Dh/2), as the JAX backbone (and
    HF Qwen2); tables and rotation match JAX to f32 rounding."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 3, 8)).astype(np.float32)
    pos = np.arange(10).reshape(2, 5).astype(np.int32)
    jc, js = jbb.rope_tables(8, 1e6, jnp.asarray(pos))
    tc, ts = tbb.rope_tables(8, 1e6, torch.from_numpy(pos))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6, atol=1e-6)
    got = tbb.apply_rope(torch.from_numpy(x), tc, ts).numpy()
    np.testing.assert_allclose(got, np.asarray(jbb.apply_rope(jnp.asarray(x), jc, js)),
                               rtol=1e-6, atol=1e-6)
    # position 1 rotates x[0] against x[Dh/2], not against x[1]
    e = np.zeros((1, 1, 1, 8), np.float32)
    e[..., 0] = 1.0
    c, s = tbb.rope_tables(8, 1e6, torch.tensor([[1]]))
    r = tbb.apply_rope(torch.from_numpy(e), c, s).numpy()[0, 0, 0]
    assert r[1] == 0 and r[4] != 0


def test_speech_head_matches_jax(jparams):
    x = np.random.default_rng(1).normal(size=(2, CFG.hidden_size)).astype(np.float32)
    for quant in (False, True):
        jp = jbb.add_speech_head(JCFG, jbb.quantize_params(jparams) if quant else jparams)
        tp = tbb.add_speech_head(CFG, tbb.quantize_params(_to_torch(jparams)) if quant
                                 else _to_torch(jparams))
        want = np.asarray(jbb._logits_speech(JCFG, jp, jnp.asarray(x)))
        got = tbb._logits_speech(CFG, tp, torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        assert tsmp.use_speech_head(CFG, config.SamplingConfig().constrained_to(CFG.layout), tp)


# --- sampling invariants (tests/test_backbone.py:102-133) ---------------------------


def test_greedy_is_argmax_and_matches_jax():
    logits = np.random.default_rng(0).normal(size=(4, 37)).astype(np.float32)
    t = tsmp.sample_tokens(torch.from_numpy(logits), greedy=True)
    np.testing.assert_array_equal(t.numpy(), logits.argmax(-1))
    j = jsmp.sample_tokens(jnp.asarray(logits), jax.random.PRNGKey(0), greedy=True)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_top_k_support():
    """Exact top-k (the port's torch.topk == JAX exact_topk=True): only the
    5 largest logits are ever sampled."""
    logits = torch.linspace(0, 1, 100)[None, :]
    gen = torch.Generator().manual_seed(0)
    picks = {int(tsmp.sample_tokens(logits, gen, top_k=5)[0]) for _ in range(64)}
    assert picks.issubset(set(range(95, 100))) and len(picks) > 1


def test_topk_candidates_match_exact_jax_topk():
    """The port's torch.topk is the exact top-k: the same candidate set and
    order as JAX `lax.top_k` (the `exact_topk=True` path; the default
    `approx_max_k` is TPU-only)."""
    logits = np.random.default_rng(3).normal(size=(4, 700)).astype(np.float32)
    tv, ti = torch.topk(torch.from_numpy(logits), 50, dim=-1)
    jv, ji = jax.lax.top_k(jnp.asarray(logits), 50)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_min_new_tokens_suppression():
    logits = torch.zeros(2, CFG.padded_vocab)
    logits[:, EOS] = 1e9
    assert (tsmp.mask_eos(logits, EOS, 0, 5)[:, EOS] == -float("inf")).all()
    assert (tsmp.mask_eos(logits, EOS, 5, 5)[:, EOS] == 1e9).all()
    gen = torch.Generator().manual_seed(0)
    scfg = config.SamplingConfig(top_k=4)
    for sup, want_eos in ((True, False), (False, True)):
        t = tsmp.sample_step(logits, gen, scfg, EOS, sup, vocab_size=CFG.vocab_size)
        assert bool((t == EOS).all()) == want_eos


def test_speech_range_constraint():
    """Constrained sampling only yields speech ids or EOS, as in JAX."""
    lay = CFG.layout
    scfg = config.SamplingConfig(top_k=50).constrained_to(lay)
    logits = torch.randn(8, CFG.padded_vocab, generator=torch.Generator().manual_seed(1))
    logits[:, :lay.speech_base] += 10.0  # off-range ids dominate the top-k
    gen = torch.Generator().manual_seed(2)
    for _ in range(8):
        t = tsmp.sample_step(logits, gen, scfg, EOS, False, vocab_size=CFG.vocab_size)
        ok = ((t >= lay.speech_base) & (t < lay.vocab_size)) | (t == EOS)
        assert bool(ok.all())
    g = tsmp.sample_step(logits, gen, config.SamplingConfig(greedy=True).constrained_to(lay),
                         EOS, True, vocab_size=CFG.vocab_size)
    jg = jsmp.sample_step(jnp.asarray(logits.numpy()), jax.random.PRNGKey(0),
                          jcfg.SamplingConfig(greedy=True).constrained_to(jcfg.TINY.layout),
                          EOS, True, vocab_size=CFG.vocab_size)
    np.testing.assert_array_equal(g.numpy(), np.asarray(jg))
