"""Port backbone, sampling and generate (neutts_tpu_torch) against the JAX
package on TINY, with the JAX weights handed to the port through
`params_from_numpy`.

Tolerances: f32 weights with an f32 or int8 cache run the same f32 math in
another summation order — 2e-4 on the logits (as tests/test_backbone.py
allows between two JAX paths). int8 weights differ only where an activation
lands within an ulp of an int8 rounding boundary — within one quantization
step, bounded at 3e-2 of the logit range. Greedy tokens must match exactly,
with the int4 cache too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neutts_tpu import config as jcfg
from neutts_tpu.models import backbone as jbb
from neutts_tpu.ops import mlp as jmlp
from neutts_tpu.ops import sampling as jsmp
from neutts_tpu.runtime import decode as jdec
from neutts_tpu_torch import config
from neutts_tpu_torch.models import backbone as tbb
from neutts_tpu_torch.models.checkpoint import params_from_numpy
from neutts_tpu_torch.ops import mlp as tmlp
from neutts_tpu_torch.ops import sampling as tsmp
from neutts_tpu_torch.runtime import decode as tdec

CFG = config.TINY
JCFG = jcfg.TINY
EOS = CFG.layout.speech_gen_end


@pytest.fixture(scope="module")
def jparams():
    return jbb.init_params(JCFG, jax.random.PRNGKey(0), dtype=jnp.float32)


@pytest.fixture(scope="module")
def jquant(jparams):
    return jbb.quantize_params(jparams)


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


@pytest.mark.parametrize("name", ["wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"])
def test_quantized_weight_layout(jparams, jquant, name):
    """quantize_params stores the MLP's int8 weights K-major (the fused MLP
    kernel's tensor-core operand layout): the [K, N] weight is a view of
    [N, K] storage equal to the JAX package's q transposed. The other
    projections stay row-major. prepare_params, which the entry points run
    on every tree, gives a JAX-quantized tree handed over through
    params_from_numpy the same layout and values; mlp_k_major leaves a
    K-major tree as it is."""
    mlp = name in ("w_gate", "w_up", "w_down")
    want = np.asarray(jquant["layers"][name]["q"])
    loaded = tbb.prepare_params(_to_torch(jquant), "cpu")
    for tree in (tbb.quantize_params(_to_torch(jparams)), loaded):
        got = tree["layers"][name]["q"]
        assert got.mT.is_contiguous() == mlp and got.is_contiguous() != mlp
        np.testing.assert_array_equal(got.mT.contiguous().numpy(), np.swapaxes(want, -1, -2))
    assert tbb.mlp_k_major(loaded) is loaded


def test_k_major_mlp_matches_jax(jquant):
    """fused_mlp_plain and _mm on the K-major MLP weights of layer 1 of the
    TINY tree give what the JAX package's fused_mlp_xla and _mm give on the
    same weights: fused_mlp within one quantization step (2e-2 of the
    output's range, as tests/test_torch_mlp.py), _mm to f32 rounding (the
    same int8 activations, an exact int32 product)."""
    tl = tbb.layer_params(tbb.mlp_k_major(_to_torch(jquant)), 1)
    jl = jax.tree_util.tree_map(lambda a: a[1], jquant["layers"])
    names = ("w_gate", "w_up", "w_down")
    assert all(tl[n]["q"].mT.is_contiguous() for n in names)
    rng = np.random.default_rng(8)
    x = (rng.normal(size=(64, CFG.hidden_size)) * 0.5).astype(np.float32)
    got = tmlp.fused_mlp_plain(torch.from_numpy(x), tl["mlp_norm"],
                               *(tl[n][k] for n in names for k in ("q", "s")))
    want = np.asarray(jmlp.fused_mlp_xla(jnp.asarray(x), jl["mlp_norm"],
                                         *(jl[n][k] for n in names for k in ("q", "s"))))
    assert np.max(np.abs(got.numpy() - want)) <= 2e-2 * np.max(np.abs(want))
    for n in names:
        h = rng.normal(size=(5, tl[n]["q"].shape[0])).astype(np.float32)
        np.testing.assert_allclose(tbb._mm(torch.from_numpy(h), tl[n]).numpy(),
                                   np.asarray(jbb._mm(jnp.asarray(h), jl[n])),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kv_dtype,quant", [
    ("float32", False), ("int8", False), ("int8", True), ("int4", False), ("auto", False),
    ("auto", True),
])
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


# --- int4 KV cache -------------------------------------------------------------------


def test_int4_helpers_match_jax():
    """quantize_kv4 (amax/7, round-half-even, clip 7), pack4_pairs, unpack4,
    scales4_block, deint4_index and dequant_kv4 equal the JAX helpers
    element for element, on values that include exact .5 ties."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(3, 10, 32)).astype(np.float32)
    x[0, 0, :3] = [3.5, -3.5, 7.0]  # amax 7: scale 1, so 3.5 is a tie (-> 4)
    jq, js = jbb.quantize_kv4(jnp.asarray(x))
    tq, ts = tbb.quantize_kv4(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert tq[0, 0, :2].tolist() == [4, -4]
    jp, tp = jbb.pack4_pairs(jq), tbb.pack4_pairs(tq)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    for a, b in zip(tbb.unpack4(tp), jbb.unpack4(jp)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    lo, hi = tbb.unpack4(tp)
    np.testing.assert_array_equal(lo.numpy(), tq.numpy()[:, 0::2])
    np.testing.assert_array_equal(hi.numpy(), tq.numpy()[:, 1::2])
    np.testing.assert_array_equal(tbb.scales4_block(ts).numpy(), np.asarray(jbb.scales4_block(js)))
    t = np.arange(20, dtype=np.int32)
    np.testing.assert_array_equal(tbb.deint4_index(torch.from_numpy(t), 10).numpy(),
                                  np.asarray(jbb.deint4_index(jnp.asarray(t), 10)))
    np.testing.assert_array_equal(
        tbb.dequant_kv4(tp, tbb.scales4_block(ts)).numpy(),
        np.asarray(jbb.dequant_kv4(jp, jbb.scales4_block(js))))
    # every pair of [-7, 7]^2 packs to one byte of [-119, 119] and back
    lo, hi = torch.meshgrid(torch.arange(-7, 8, dtype=torch.int8),
                            torch.arange(-7, 8, dtype=torch.int8), indexing="ij")
    b = tbb.pack4(lo, hi)
    assert int(b.abs().max()) == 119 and b.unique().numel() == 225
    assert all(torch.equal(a, c) for a, c in zip(tbb.unpack4(b), (lo, hi)))


def _nibbles(buf, pad):
    """Packed [L, B, T/2, KD] -> int4 values [L, B, T, KD] with the slots
    before each row's pad zeroed (they hold pad-token K/V, masked everywhere)."""
    lo, hi = jbb.unpack4(jnp.asarray(buf))
    L, B, T2, KD = lo.shape
    out = np.asarray(jnp.stack([lo, hi], axis=3).reshape(L, B, 2 * T2, KD)).copy()
    for b, p in enumerate(pad):
        out[:, b, :p] = 0
    return out


@pytest.mark.parametrize("quant", [False, True])
def test_int4_prefill_cache_matches_jax(jparams, quant):
    """After prefill of two ragged prompts (odd pads), the int4 caches of
    both packages hold the same nibbles on every real slot and the same
    prev registers (the last prompt token), and scales within 1e-5: the
    f32 projections sum in another order, so an amax may differ by an ulp
    (and a nibble by one step where x/scale lands within that ulp of a .5
    tie; none does here). Pad slots hold pad-token K/V in both packages,
    whose values past layer 0 depend on how each masks a fully padded row."""
    jc, tc = JCFG.scaled(kv_dtype="int4"), CFG.scaled(kv_dtype="int4")
    jp = jbb.quantize_params(jparams) if quant else jparams
    prompts = [[5, 6, 7, 8, 9, 10, 11], [12, 13, 14, 15]]
    jt, jl = jdec.pad_prompts(prompts, pad_id=0, bucket=16)
    tt, tl = tdec.pad_prompts(prompts, pad_id=0, bucket=16, device="cpu")
    _, jcache = jbb.prefill(jc, jp, jt, jl, jbb.KVCache.create(jc, 2, max_len=32))
    _, tcache = tbb.prefill(tc, _to_torch(jp), tt, tl,
                            tbb.KVCache.create(tc, 2, max_len=32, device="cpu"))
    pad = [16 - len(p) for p in prompts]  # 9 and 12: the first real token is odd in row 0
    assert tcache.k.shape == jcache.k.shape == (2, 2, 16, 32) and tcache.max_len == 32
    for name in ("k", "v"):
        np.testing.assert_array_equal(_nibbles(getattr(tcache, name).numpy(), pad),
                                      _nibbles(getattr(jcache, name), pad), err_msg=name)
    for name in ("k_prev", "v_prev"):
        np.testing.assert_array_equal(getattr(tcache, name).numpy(),
                                      np.asarray(getattr(jcache, name)), err_msg=name)
    for name in ("k_scale", "v_scale"):
        ts, js = getattr(tcache, name).numpy(), np.asarray(getattr(jcache, name))
        for b, p in enumerate(pad):
            cols = [t // 2 + (t % 2) * 16 for t in range(p, 16)]
            np.testing.assert_allclose(ts[:, b, cols], js[:, b, cols], rtol=1e-5, err_msg=name)


def test_auto_odd_bucket_falls_back_to_int8(jparams):
    """Mirror of tests/test_pipeline.py::test_near_window_odd_prompt_int4_auto:
    near the window edge the bucket rounds up to even while that fits; at
    max_context - 1 the odd bucket stays, and "auto" resolves to int8 for
    that call (int4 packs token pairs) instead of failing, with the JAX
    package's tokens."""
    from neutts_tpu_torch.pipeline import NeuTTS

    cfg = CFG.scaled(kv_dtype="auto")
    tts = NeuTTS.initialize_random(cfg, device="cpu")
    assert tts._pick_bucket(509) == 510  # TINY max_context 512
    assert tts._pick_bucket(508) == 508
    assert tts._pick_bucket(511) == 511
    assert tts._pick_bucket(100) == tdec.bucket_length(100)
    assert tdec.resolve_cfg(cfg, 511, 1).kv_dtype == "int8"
    assert tdec.resolve_cfg(cfg, 510, 1).kv_dtype == "int4"
    scfg = dict(greedy=True, min_new_tokens=1)
    jt, jl = jdec.pad_prompts([[5] * 511], pad_id=0, bucket=511)
    tt, tl = tdec.pad_prompts([[5] * 511], pad_id=0, bucket=511, device="cpu")
    jr = jdec.generate(JCFG.scaled(kv_dtype="auto"), jcfg.SamplingConfig(**scfg), EOS, 4, jparams,
                       jt, jl, jax.random.PRNGKey(1))
    tr = tdec.generate(cfg, config.SamplingConfig(**scfg), EOS, 4, _to_torch(jparams), tt, tl)
    np.testing.assert_array_equal(tr.tokens.numpy(), np.asarray(jr.tokens))


@pytest.mark.parametrize("path", ["staged", "scatter"])
def test_int4_odd_prompt_write_preserves_prompt_nibble(jparams, path):
    """Mirror of tests/test_backbone.py::test_int4_odd_prompt_write_preserves_prompt_nibble:
    decode writes share packed bytes with earlier tokens and must never
    clobber the prompt's LAST token (at odd slot Lp - 1 = 7 of the bucket,
    left padding) — through the staged segment (16 steps: the int4 segment
    alignment) and through the direct-write path with its prev registers."""
    from neutts_tpu_torch.runtime import batching

    cfg4 = CFG.scaled(kv_dtype="int4")
    params = _to_torch(jparams)
    scfg = config.SamplingConfig(greedy=True, min_new_tokens=1)
    prompt, Lp = [3, 1, 4, 1, 5], 8
    state = batching.SlotState.create(cfg4, 2, "cpu", seed=3)
    state = batching.prefill_slots(cfg4, scfg, EOS, params, state,
                                   torch.tensor([[0, 0, 0] + prompt], dtype=torch.int32),
                                   torch.tensor([len(prompt)], dtype=torch.int32),
                                   torch.tensor([0], dtype=torch.int32))

    def deq_last_token(state):
        return torch.stack([tbb.dequant_kv4(state.cache.k[l, 0:1], state.cache.k_scale[l, 0:1])[
            0, Lp - 1] for l in range(cfg4.n_layers)])

    before = deq_last_token(state)
    if path == "staged":
        state, _ = batching.decode_steps(cfg4, scfg, EOS, batching.SEGMENT_ALIGN_INT4, params,
                                         state)
    else:
        state, _ = batching._decode_steps_scatter(cfg4, scfg, EOS, 5, params, state)
    assert torch.equal(before, deq_last_token(state))
    assert int(state.lens[0]) > Lp  # decoding went past the shared byte


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
