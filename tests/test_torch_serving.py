"""Port serving engine (neutts_tpu_torch.serving, runtime.batching) on the CPU.

Greedy outputs of the port's Engine must equal, token for token, the port's
lockstep `generate` per request and the JAX package's Engine on the same
weights (handed over through `params_from_numpy`). With the int8 and int4
caches the port runs its segment-staged path on every device (the plain
versions of the staged attention, reconcile and admission-write kernels
here), where the JAX package runs staging only on a TPU. Cases mirror
tests/test_serving.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neutts_tpu import config as jcfg
from neutts_tpu.models import backbone as jbb
from neutts_tpu.serving.engine import Engine as JEngine
from neutts_tpu_torch import config
from neutts_tpu_torch.models import backbone as tbb
from neutts_tpu_torch.models.checkpoint import params_from_numpy
from neutts_tpu_torch.runtime import batching
from neutts_tpu_torch.runtime import decode as dec
from neutts_tpu_torch.serving import Engine
from neutts_tpu_torch.serving import engine as eng_mod

import _torch_threads  # noqa: F401  (pins torch's threads in this process)

CFG = config.TINY
JCFG = jcfg.TINY
EOS = CFG.layout.speech_gen_end


@pytest.fixture(scope="module")
def jparams():
    return jbb.init_params(JCFG, jax.random.PRNGKey(0), dtype=jnp.float32)


@pytest.fixture(scope="module")
def params(jparams):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), "cpu")


def engine(params, cfg=CFG, **kw):
    return Engine(cfg, params, eos_id=EOS, device="cpu", **kw)


def lockstep_greedy(params, prompt, max_new=24, cfg=CFG):
    scfg = config.SamplingConfig(greedy=True, min_new_tokens=2)
    toks, lens = dec.pad_prompts([prompt], pad_id=0, bucket=128, device="cpu")
    return dec.extract(dec.generate(cfg, scfg, EOS, max_new, params, toks, lens), 0, EOS)


@pytest.mark.parametrize("kv_dtype", ["float32", "int8", "int4"])
def test_engine_matches_lockstep(params, kv_dtype):
    cfg = CFG.scaled(kv_dtype=kv_dtype)
    scfg = config.SamplingConfig(greedy=True, min_new_tokens=2)
    eng = engine(params, cfg, n_slots=2, sampling=scfg, segment_steps=8)
    prompts = [[3, 1, 4, 1, 5], [9, 2, 6, 5, 3, 5, 8], [2, 7, 1], [8, 2, 8, 1, 8], [31, 41, 59]]
    rids = [eng.submit(p, max_new=24) for p in prompts]
    results = eng.run()
    assert set(results) == set(rids)
    for rid, prompt in zip(rids, prompts):
        assert results[rid] == lockstep_greedy(params, prompt, 24, cfg), rid


def test_engine_slot_reuse_more_requests_than_slots(params):
    scfg = config.SamplingConfig(greedy=True, min_new_tokens=1)
    eng = engine(params, n_slots=1, sampling=scfg, segment_steps=4)
    assert eng.segment_steps == batching.SEGMENT_ALIGN  # rounded up to the alignment
    rids = [eng.submit([5 + i, 6, 7], max_new=6) for i in range(4)]
    results = eng.run()
    assert len(results) == 4
    for i, rid in enumerate(rids):
        assert results[rid] == lockstep_greedy(params, [5 + i, 6, 7], 6)


def test_engine_grouped_admission_matches_lockstep(params):
    """7 requests into 8 slots: one grouped prefill padded with duplicate
    slot rows (G=16 over 7 admissions), int8 cache (the admission write
    goes through scatter_prefill)."""
    cfg = CFG.scaled(kv_dtype="int8")
    scfg = config.SamplingConfig(greedy=True, min_new_tokens=2)
    eng = engine(params, cfg, n_slots=8, sampling=scfg, segment_steps=8)
    prompts = [[3 + i, 7, 2, 9] for i in range(7)]
    rids = [eng.submit(p, max_new=12) for p in prompts]
    results = eng.run()
    for rid, prompt in zip(rids, prompts):
        assert results[rid] == lockstep_greedy(params, prompt, 12, cfg), rid


@pytest.mark.parametrize("kv_dtype", ["float32", "int8", "int4"])
@pytest.mark.parametrize("seed", [11, 22, 33])
def test_engine_randomized_workloads_match_lockstep(params, seed, kv_dtype):
    """Random prompt lengths, budgets, slot counts and segment sizes must
    reproduce the lockstep oracle per request: admission grouping,
    predictive retirement, pipelined collection and slot reuse together
    (with int8 and int4, staged segments and reconciles under slot
    turnover; int4 segments round up to 16 steps)."""
    cfg = CFG.scaled(kv_dtype=kv_dtype)
    rng = np.random.default_rng(seed)
    n_slots = int(rng.integers(1, 5))
    segment = int(rng.choice([8, 16]))
    scfg = config.SamplingConfig(greedy=True, min_new_tokens=2)
    eng = engine(params, cfg, n_slots=n_slots, sampling=scfg, segment_steps=segment)
    n_req = int(rng.integers(3, 9))
    prompts = [[int(t) for t in rng.integers(1, 300, size=int(rng.integers(1, 90)))]
               for _ in range(n_req)]
    budgets = [int(rng.integers(1, 40)) for _ in range(n_req)]
    rids = [eng.submit(p, max_new=b) for p, b in zip(prompts, budgets)]
    results = eng.run()
    assert set(results) == set(rids)
    for rid, p, b in zip(rids, prompts, budgets):
        assert results[rid] == lockstep_greedy(params, p, b, cfg), (seed, rid)


@pytest.mark.parametrize("kv_dtype", ["float32", "int8", "int4", "auto"])
def test_engine_matches_jax_engine(jparams, params, kv_dtype):
    """The same requests through the port's Engine and the JAX Engine on the
    same weights: identical greedy tokens and stats (the port stages int8
    and int4 decode, the JAX Engine on the CPU scatters; "auto" resolves to
    int4 in both, with 16-step segments)."""
    scfg = dict(greedy=True, min_new_tokens=2)
    prompts = [[3, 1, 4, 1, 5], [9, 2, 6], [2, 7, 1, 8, 2, 8], [11, 12]]
    budgets = [20, 9, 14, 17]
    teng = engine(params, CFG.scaled(kv_dtype=kv_dtype), n_slots=2,
                  sampling=config.SamplingConfig(**scfg), segment_steps=8)
    jeng = JEngine(JCFG.scaled(kv_dtype=kv_dtype), jparams, eos_id=EOS, n_slots=2,
                   sampling=jcfg.SamplingConfig(**scfg), segment_steps=8)
    trids = [teng.submit(p, max_new=b) for p, b in zip(prompts, budgets)]
    jrids = [jeng.submit(p, max_new=b) for p, b in zip(prompts, budgets)]
    assert teng.cfg.kv_dtype == jeng.cfg.kv_dtype != "auto"
    assert teng.segment_steps == jeng.segment_steps
    tres, jres = teng.run(), jeng.run()
    for tr, jr in zip(trids, jrids):
        assert tres[tr] == jres[jr], (tr, tres[tr][:6], jres[jr][:6])
    assert teng.stats == jeng.stats


def _admit(params, cfg, prompts, Lp, n_slots, pad_to=None):
    """prefill_slots of `prompts` into slots 0.., the last repeated up to
    `pad_to` rows (the engine's group padding)."""
    scfg = config.SamplingConfig(greedy=True, min_new_tokens=1)
    state = batching.SlotState.create(cfg, n_slots, "cpu", seed=3)
    group = list(enumerate(prompts))
    group += [group[-1]] * ((pad_to or len(group)) - len(group))
    toks = np.zeros((len(group), Lp), np.int32)
    for j, (_, p) in enumerate(group):
        toks[j, Lp - len(p):] = p  # LEFT-padded (engine admission layout)
    lens = np.asarray([len(p) for _, p in group], np.int32)
    return batching.prefill_slots(cfg, scfg, EOS, params, state, torch.from_numpy(toks),
                                  torch.from_numpy(lens),
                                  torch.tensor([s for s, _ in group], dtype=torch.int32))


@pytest.mark.parametrize("kv_dtype,Lp", [
    ("float32", 8), ("int8", 64), ("int8", 8), ("int4", 64), ("int4", 8),
])
def test_prefill_slots_duplicate_padding_idempotent(params, kv_dtype, Lp):
    """Duplicated trailing rows (group padding) leave the same state as the
    real rows alone; with int8 (int4) every bucket takes the scatter_prefill
    (scatter_prefill4) write."""
    cfg = CFG.scaled(kv_dtype=kv_dtype)
    prompts = [[5, 6, 7], [8, 9, 1, 2]]
    plain = _admit(params, cfg, prompts, Lp, 4)
    padded = _admit(params, cfg, prompts, Lp, 4, pad_to=4)
    for name in ("token", "lens", "pad", "prompt_lens", "active"):
        assert torch.equal(getattr(plain, name), getattr(padded, name)), name
    for name in ("k", "v", "k_scale", "v_scale", "k_prev", "v_prev"):
        a, b = getattr(plain.cache, name), getattr(padded.cache, name)
        assert (a is None and b is None) or torch.equal(a, b), name


def test_prefill_slots_int4_rejects_odd_bucket(params):
    """An odd admission bucket cannot hold whole nibble pairs: it raises and
    leaves the cache as it was."""
    cfg = CFG.scaled(kv_dtype="int4")
    state = batching.SlotState.create(cfg, 2, "cpu")
    before = state.cache.k.clone()
    with pytest.raises(ValueError):
        batching.prefill_slots(cfg, config.SamplingConfig(greedy=True), EOS, params, state,
                               torch.ones((1, 7), dtype=torch.int32),
                               torch.tensor([5], dtype=torch.int32),
                               torch.tensor([0], dtype=torch.int32))
    assert torch.equal(state.cache.k, before)


@pytest.mark.parametrize("kv_dtype", ["float32", "int8", "int4"])
def test_prefill_slot_matches_jax(jparams, params, kv_dtype):
    """Single-request admission into slot 1 of 3 against the JAX
    `prefill_slot` on the same weights: equal per-slot state, the cache's
    attended slots [pad, T) within f32 rounding (int8, int4: within one
    quantization step; int4 also the prev registers, the last prompt
    token's values). Left-pad slots are never attended, and past the first
    layer their values depend on how a fully masked query row is handled."""
    from neutts_tpu.runtime import batching as jbatching

    cfg, jc = CFG.scaled(kv_dtype=kv_dtype), JCFG.scaled(kv_dtype=kv_dtype)
    prompt, Lp = [9, 2, 6, 5, 3], 16
    toks = np.zeros((Lp,), np.int32)
    toks[Lp - len(prompt):] = prompt
    scfg = dict(greedy=True, min_new_tokens=1)
    t = batching.prefill_slot(cfg, config.SamplingConfig(**scfg), EOS, params,
                              batching.SlotState.create(cfg, 3, "cpu"),
                              torch.from_numpy(toks), len(prompt), 1)
    j = jbatching.prefill_slot(jc, jcfg.SamplingConfig(**scfg), EOS, jparams,
                               jbatching.SlotState.create(jc, 3, jax.random.PRNGKey(0)),
                               jnp.asarray(toks), jnp.int32(len(prompt)), jnp.int32(1))
    for name in ("token", "lens", "pad", "prompt_lens", "active"):
        np.testing.assert_array_equal(getattr(t, name).numpy(), np.asarray(getattr(j, name)),
                                      err_msg=name)
    pad = Lp - len(prompt)
    if t.cache.int4:
        # nibbles equal on the real slots, scales to 1e-5 (f32 summation
        # order), prev registers equal
        half = t.cache.k_scale.shape[2] // 2
        cols = [p // 2 + (p % 2) * half for p in range(pad, Lp)]
        for name in ("k", "v", "k_scale", "v_scale", "k_prev", "v_prev"):
            tv, jv = getattr(t.cache, name), torch.from_numpy(np.array(getattr(j.cache, name)))
            if name in ("k", "v"):
                tv, jv = (torch.stack(tbb.unpack4(x), dim=3).flatten(2, 3)[:, :, pad:Lp]
                          for x in (tv, jv))
            elif name in ("k_scale", "v_scale"):
                tv, jv = tv[:, :, cols], jv[:, :, cols]
            torch.testing.assert_close(tv, jv, rtol=1e-5, atol=0, msg=name)
        return
    for name, scale in (("k", "k_scale"), ("v", "v_scale")):
        tv, jv = getattr(t.cache, name).float(), np.asarray(getattr(j.cache, name), np.float32)
        if t.cache.quantized:
            tv = tv * getattr(t.cache, scale)[..., None]
            jv = jv * np.asarray(getattr(j.cache, scale))[..., None]
        tv, jv = tv[:, :, pad:], jv[:, :, pad:]
        np.testing.assert_allclose(tv.numpy(), jv, atol=0.15 if t.cache.quantized else 1e-4,
                                   rtol=0.05 if t.cache.quantized else 1e-4)


def test_staged_decode_matches_scatter_path(params):
    """int8: the staged segment (staging writes, staged attention, reconcile)
    against the direct-write path over two segments: the same greedy
    tokens, lens and active flags; the prompt region bit-exact, the decoded
    region equal after dequantization within one quantization step."""
    cfg8 = CFG.scaled(kv_dtype="int8")
    scfg = config.SamplingConfig(greedy=True, min_new_tokens=1)
    prompts = [[3, 1, 4, 1, 5], [9, 2, 6], [2, 7, 1, 8, 2, 8], [5]]
    Lp, S = 8, 8
    sA = _admit(params, cfg8, prompts, Lp, 4)
    sB = _admit(params, cfg8, prompts, Lp, 4)
    for _ in range(2):  # the second segment runs on bases advanced by S
        sA, outA = batching._decode_steps_staged(cfg8, scfg, EOS, S, params, sA)
        sB, outB = batching._decode_steps_scatter(cfg8, scfg, EOS, S, params, sB)
        assert torch.equal(outA, outB)
    assert torch.equal(sA.lens, sB.lens) and torch.equal(sA.active, sB.active)
    assert torch.equal(sA.cache.k[:, :, :Lp], sB.cache.k[:, :, :Lp])
    for b in range(len(prompts)):
        n = int(sA.lens[b])
        for name, scale in (("k", "k_scale"), ("v", "v_scale")):
            da, db = (getattr(s.cache, name)[:, b, :n].float()
                      * getattr(s.cache, scale)[:, b, :n, None] for s in (sA, sB))
            np.testing.assert_allclose(da.numpy(), db.numpy(), atol=0.15, rtol=0.05)


def test_staged_decode_matches_scatter_path_int4(params):
    """Mirror of tests/test_serving.py::test_staged_decode_matches_scatter_path_int4:
    the int4 staged segments (unpacked staging, staged attention, packing
    reconcile at even bases) against the int4 direct-write path over two
    16-step segments. Tokens, lens and active flags equal; the prompt bytes
    bit-exact; the decoded region within one nibble step and 1e-5 relative
    on the scales: the two plain attentions reduce in different orders
    ([T + S] concatenated against [T]), so hidden states differ by f32 ulps
    and a quantizer tie may flip one nibble. A misplaced byte or scale puts
    unrelated values there, far outside these bounds."""
    cfg4 = CFG.scaled(kv_dtype="int4")
    scfg = config.SamplingConfig(greedy=True, min_new_tokens=1)
    prompts = [[3, 1, 4, 1, 5], [9, 2, 6], [2, 7, 1, 8, 2, 8], [5]]
    Lp, S = 16, batching.SEGMENT_ALIGN_INT4
    sA = _admit(params, cfg4, prompts, Lp, 4)
    sB = _admit(params, cfg4, prompts, Lp, 4)
    for _ in range(2):
        sA, outA = batching._decode_steps_staged(cfg4, scfg, EOS, S, params, sA)
        sB, outB = batching._decode_steps_scatter(cfg4, scfg, EOS, S, params, sB)
        assert torch.equal(outA, outB)
    assert torch.equal(sA.lens, sB.lens) and torch.equal(sA.active, sB.active)
    assert torch.equal(sA.cache.k[:, :, :Lp // 2], sB.cache.k[:, :, :Lp // 2])
    half = sA.cache.k_scale.shape[2] // 2
    for b in range(len(prompts)):
        n = int(sA.lens[b])
        for name in ("k", "v"):
            a, c = (torch.stack(tbb.unpack4(getattr(s.cache, name)[:, b, : n // 2]))
                    for s in (sA, sB))
            assert int((a.int() - c.int()).abs().max()) <= 1, (name, b)
        for name in ("k_scale", "v_scale"):
            a, c = (getattr(s.cache, name)[:, b] for s in (sA, sB))
            np.testing.assert_allclose(a[:, : (n + 1) // 2].numpy(), c[:, : (n + 1) // 2].numpy(),
                                       rtol=1e-5)
            np.testing.assert_allclose(a[:, half: half + n // 2].numpy(),
                                       c[:, half: half + n // 2].numpy(), rtol=1e-5)


def _admit_more(params, cfg, state, prompt, Lp, slot):
    """prefill_slots of one more prompt into `slot` of `state`."""
    toks = np.zeros((1, Lp), np.int32)
    toks[0, Lp - len(prompt):] = prompt
    return batching.prefill_slots(cfg, config.SamplingConfig(greedy=True, min_new_tokens=1),
                                  EOS, params, state, torch.from_numpy(toks),
                                  torch.tensor([len(prompt)], dtype=torch.int32),
                                  torch.tensor([slot], dtype=torch.int32))


@pytest.mark.parametrize("kv_dtype", ["int8", "int4"])
def test_segment_graph_body_matches_staged_segment(params, kv_dtype):
    """The body a CUDA graph captures, run here directly on its static
    buffers with the same copy-in and clone-out, against the eager staged
    segment over three segments with a retirement and admissions between
    them: tokens, lens, active and the cache equal; the call's input
    tensors unchanged, and no returned tensor aliases a static buffer."""
    cfg = CFG.scaled(kv_dtype=kv_dtype)
    scfg = config.SamplingConfig(greedy=True, min_new_tokens=1)
    prompts = [[3, 1, 4, 1, 5], [9, 2, 6], [2, 7, 1, 8, 2, 8]]
    Lp, S = 16, batching.SEGMENT_ALIGN_INT4 if kv_dtype == "int4" else batching.SEGMENT_ALIGN
    sA = _admit(params, cfg, prompts, Lp, 4)
    sB = _admit(params, cfg, prompts, Lp, 4)
    seg = batching._SegmentGraph(cfg, scfg, EOS, S, params, sA)
    buffers = {getattr(seg.static, n).data_ptr() for n in batching._SLOT_INPUTS}
    for r in range(3):
        if r == 1:  # slot 1 retires; slots 1 and 3 take new requests
            retire = torch.tensor([False, True, False, False])
            sA, sB = (batching.retire_slots(s, retire) for s in (sA, sB))
            for slot, prompt in ((1, [5, 8, 9, 7]), (3, [6, 2])):
                sA, sB = (_admit_more(params, cfg, s, prompt, Lp, slot) for s in (sA, sB))
        inputs = {n: getattr(sA, n) for n in batching._SLOT_INPUTS}
        before = {n: t.clone() for n, t in inputs.items()}
        held = []  # the body's outputs, which a graph keeps as its result

        def body():
            held.extend(seg.body())
            return held

        sA, outA = seg.run(sA, body)
        sB, outB = batching._decode_steps_staged(cfg, scfg, EOS, S, params, sB)
        assert torch.equal(outA, outB), r
        for n in ("token", "lens", "active"):
            assert torch.equal(getattr(sA, n), getattr(sB, n)), (r, n)
        for n, t in inputs.items():
            assert torch.equal(t, before[n]), (r, n)
        held = buffers | {t.data_ptr() for t in held}
        assert not held & {t.data_ptr() for t in (outA, sA.token, sA.lens, sA.active)}
    for f in ("k", "v", "k_scale", "v_scale"):
        assert torch.equal(getattr(sA.cache, f), getattr(sB.cache, f)), f


def test_segment_graph_serves_only_what_it_baked_in(params):
    """A captured segment replays only for its own cache tensors, generator,
    params object, config, sampling config and EOS id; the CPU's
    `decode_steps` stays eager and captures nothing."""
    cfg = CFG.scaled(kv_dtype="int8")
    scfg = config.SamplingConfig(greedy=True, min_new_tokens=1)
    state = _admit(params, cfg, [[3, 1, 4]], 16, 2)
    seg = batching._SegmentGraph(cfg, scfg, EOS, 8, params, state)
    assert seg.serves(cfg, scfg, EOS, params, state)
    other = batching.SlotState.create(cfg, 2, "cpu")
    assert not seg.serves(cfg, scfg, EOS, params, other)
    assert not seg.serves(cfg, scfg, EOS, dict(params), state)
    assert not seg.serves(cfg, config.SamplingConfig(greedy=True, min_new_tokens=2), EOS,
                          params, state)
    assert not seg.serves(cfg, scfg, EOS + 1, params, state)
    assert not seg.serves(cfg.scaled(max_context=cfg.max_context + 128), scfg, EOS, params,
                          state)
    state.generator = torch.Generator().manual_seed(1)
    assert not seg.serves(cfg, scfg, EOS, params, state)
    state, _ = batching.decode_steps(cfg, scfg, EOS, 8, params, state)
    assert state.graphs == {}


def _group(prompts, slots, Lp):
    """tokens [G, Lp] LEFT-padded, true lengths [G] and slots [G] of one
    admission group."""
    toks = torch.zeros((len(prompts), Lp), dtype=torch.int32)
    for j, p in enumerate(prompts):
        toks[j, Lp - len(p):] = torch.tensor(p, dtype=torch.int32)
    return (toks, torch.tensor([len(p) for p in prompts], dtype=torch.int32),
            torch.tensor(slots, dtype=torch.int32))


# two shapes, each twice; the (3, 8) groups are padded (a duplicate slot)
ADMISSIONS = [([[3, 1, 4, 1, 5], [9, 2, 6]], [0, 4], 16),
              ([[2, 7, 1, 8], [6, 2], [6, 2]], [1, 3, 3], 8),
              ([[5, 8, 9, 7], [1, 1]], [4, 5], 16),
              ([[4, 4, 4], [7], [7]], [0, 2, 2], 8)]


@pytest.mark.parametrize("kv_dtype", ["float32", "int8", "int4"])
def test_admit_graph_body_matches_eager_admission(params, kv_dtype):
    """The body an admission's CUDA graph captures, run here directly on its
    static buffers with the same copy-in and clone-out, against the eager
    admission over two shapes, the second a padded group with a duplicate
    slot, each admitted twice: the five per-slot tensors and the cache
    equal; the call's inputs and the state's old tensors unchanged; no
    returned tensor aliases a buffer. The CPU's `prefill_slots` captures
    nothing."""
    cfg = CFG.scaled(kv_dtype=kv_dtype)
    scfg = config.SamplingConfig(greedy=True, min_new_tokens=1)
    sA, sB = (batching.SlotState.create(cfg, 6, "cpu", seed=3) for _ in range(2))
    graphs = {}
    for prompts, slots, Lp in ADMISSIONS:
        inputs = _group(prompts, slots, Lp)
        key = tuple(inputs[0].shape)
        g = graphs.setdefault(key, batching._AdmitGraph(cfg, scfg, EOS, params, sA, *key))
        assert g.serves(cfg, scfg, EOS, params, sA) and not g.serves(cfg, scfg, EOS, params, sB)
        old = [getattr(sA, n) for n in batching._SLOT_INPUTS] + list(inputs)
        before = [t.clone() for t in old]
        held = []  # the body's outputs, which a graph keeps as its result

        def body():
            held.extend(g.body())
            return held

        sA, out = g.run(sA, body, *inputs)
        sB = batching._prefill_slots_eager(cfg, scfg, EOS, params, sB, *inputs)
        assert out is None
        for n in batching._SLOT_INPUTS:
            assert torch.equal(getattr(sA, n), getattr(sB, n)), (key, n)
        for t, b in zip(old, before):
            assert torch.equal(t, b), key
        buffers = {t.data_ptr() for t in (*g.inputs, *held,
                                          *(getattr(g.static, n) for n in batching._SLOT_INPUTS))}
        assert not buffers & {getattr(sA, n).data_ptr() for n in batching._SLOT_INPUTS}
    assert sA.active[[0, 1, 2, 3, 4, 5]].all()
    for f in ("k", "v", "k_scale", "v_scale", "k_prev", "v_prev"):
        a, b = getattr(sA.cache, f), getattr(sB.cache, f)
        assert (a is None and b is None) or torch.equal(a, b), f
    sC = batching.prefill_slots(cfg, scfg, EOS, params, sB, *_group([[3, 4]], [5], 8))
    assert sC.admit_graphs == {}


def test_predictive_retirement_caps_frees_at_queue_depth(params):
    """More budget-complete slots than queued requests: only queue-depth
    slots may be freed predictively; the rest retire normally and the empty
    counter stays at the structural tail."""
    scfg = config.SamplingConfig(min_new_tokens=64)
    eng = engine(params, n_slots=4, sampling=scfg, segment_steps=8)
    rng = np.random.default_rng(0)
    prompts = [(rng.integers(0, 50, size=12) + CFG.layout.speech_base).tolist()
               for _ in range(5)]
    for p in prompts[:4]:
        eng.submit(p, max_new=17)
    eng.submit(prompts[4], max_new=9)
    res = eng.run(pipelined=True)
    assert sorted(len(t) for t in res.values()) == [9, 17, 17, 17, 17]
    s = eng.stats
    assert s["useful_tokens"] == 9 + 4 * 17
    assert s["empty_token_slots"] <= s["dispatched_token_slots"] // 2, s


def test_constrained_sampling_stays_in_speech_range(params):
    lay = CFG.layout
    scfg = config.SamplingConfig(min_new_tokens=1, top_k=50).constrained_to(lay)
    eng = engine(params, n_slots=2, sampling=scfg, segment_steps=8)
    assert "lm_head_speech" in eng.params  # attached for constrained sampling
    rids = [eng.submit([3, 1, 4, 1, 5], max_new=40), eng.submit([2, 7, 1], max_new=40)]
    results = eng.run()
    tokens = [t for rid in rids for t in results[rid]]
    assert tokens and all(lay.speech_base <= t < lay.vocab_size for t in tokens)


def test_engine_rejects_oversize_prompt(params):
    eng = engine(params, n_slots=1)
    with pytest.raises(ValueError):
        eng.submit(list(range(CFG.max_context)))


def test_no_silent_truncation_with_large_bucket_pad(params, monkeypatch):
    """A prompt whose bucket left pad is large still generates up to
    max_context - len(prompt) tokens (the reference's max_length)."""
    monkeypatch.setattr(eng_mod, "bucket_length", lambda n: 128 if n <= 128 else 512)
    scfg = config.SamplingConfig(min_new_tokens=10_000, top_k=50)  # EOS suppressed
    eng = engine(params, n_slots=1, sampling=scfg, segment_steps=8)
    prompt = [(i * 7) % 300 for i in range(130)]
    cap = CFG.max_context - len(prompt)
    rid = eng.submit(prompt, max_new=cap)
    assert len(eng.run()[rid]) == cap


def test_cache_slack_and_slot_length():
    assert batching.CACHE_SLACK == 256
    assert batching.slot_cache_len(config.AIR) == 2304
    assert batching.slot_cache_len(CFG) == 768
    # int4: 512-aligned, as in the JAX package (packed rows hold half)
    assert batching.slot_cache_len(config.AIR.scaled(kv_dtype="int4")) == 2560
    assert batching.slot_cache_len(CFG.scaled(kv_dtype="int4")) == 1024


def test_engine_defaults_to_cuda(params):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        Engine(CFG, params, eos_id=EOS)
