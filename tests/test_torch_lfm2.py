"""The LFM2-MoE backbone in the port's serving engine (models/lfm2.py,
ops/moe.py, runtime/batching.py), on the CPU at a tiny seeded size, against
the plain float32 reference `tests/reference_lfm2.py` (no port code).

The engine's prefill then decode, through the int8 KV cache of the
attention layers and the conv state of the conv layers, across segments
with admissions and retirements, is compared with the reference's full
forward pass on logits; a left-padded prompt's conv state equals the
unpadded one's; the expert bias moves the choice of experts and not their
weights; the grouped expert op's plain version equals a per-token loop;
the Qwen2 block's engine is as it was.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from neutts_tpu_torch import config
from neutts_tpu_torch.models import backbone as tbb
from neutts_tpu_torch.models import lfm2
from neutts_tpu_torch.ops import moe as moe_ops
from neutts_tpu_torch.ops import sampling as smp
from neutts_tpu_torch.runtime import batching
from neutts_tpu_torch.runtime import decode as dec
from neutts_tpu_torch.serving import Engine

import _torch_threads  # noqa: F401  (pins torch's threads in this process)
import reference_lfm2

CFG = config.LFM2_TINY.scaled(kv_dtype="int8")
EOS = CFG.layout.speech_gen_end
# greedy over the whole vocabulary, EOS held off: every step serves a token
SCFG = config.SamplingConfig(greedy=True, min_new_tokens=10_000)


def sizes(cfg=CFG) -> dict:
    return {"layer_types": cfg.layer_types, "conv_L_cache": cfg.conv_kernel,
            "num_experts": cfg.n_experts, "num_experts_per_tok": cfg.n_experts_per_tok,
            "num_dense_layers": cfg.n_dense_layers, "norm_topk_prob": True,
            "routed_scaling_factor": 1.0, "num_attention_heads": cfg.n_heads,
            "num_key_value_heads": cfg.n_kv_heads, "head_dim": cfg.head_dim,
            "rope_theta": cfg.rope_theta, "norm_eps": cfg.rms_norm_eps,
            "vocab_size": cfg.vocab_size}


@pytest.fixture(scope="module")
def params():
    """Seeded weights whose norm gains and expert bias are not the identity."""
    p = lfm2.init_params(CFG, seed=5, device="cpu")
    gen = torch.Generator().manual_seed(6)
    for group, name in (("layers", "op_norm"), ("layers", "ffn_norm"), ("attn", "q_norm"),
                        ("attn", "k_norm")):
        t = p[group][name]
        t.add_(0.1 * torch.randn(t.shape, generator=gen))
    p["final_norm"].add_(0.1 * torch.randn(p["final_norm"].shape, generator=gen))
    p["moe"]["expert_bias"].copy_(0.1 * torch.randn(p["moe"]["expert_bias"].shape,
                                                    generator=gen))
    return p


def _admit(params, state, prompts, slots, Lp=64):
    toks = np.zeros((len(prompts), Lp), np.int32)
    for j, pr in enumerate(prompts):
        toks[j, Lp - len(pr):] = pr
    return batching.prefill_slots(CFG, SCFG, EOS, params, state, torch.from_numpy(toks),
                                  torch.tensor([len(p) for p in prompts], dtype=torch.int32),
                                  torch.tensor(slots, dtype=torch.int32))


def test_engine_prefill_and_decode_match_the_reference_on_logits(params, monkeypatch):
    """Three segments over 4 slots: two admissions, a retirement and a
    re-admission into the retired slot. Every logit row the engine sampled
    from equals the reference's at that position."""
    recorded = []  # (logits [rows, V], rows: None for an admission group)
    orig = smp.sample_from_hidden

    def sample_from_hidden(cfg, sampling, p, x, gen, eos_id, suppress):
        recorded.append(tbb._logits(cfg, p, x, trim=True))
        return orig(cfg, sampling, p, x, gen, eos_id, suppress)

    monkeypatch.setattr(smp, "sample_from_hidden", sample_from_hidden)
    rng = np.random.default_rng(0)
    prompt = lambda n: rng.integers(0, CFG.vocab_size - 1, n).tolist()  # noqa: E731
    state = batching.SlotState.create(CFG, 4, "cpu")
    slot_log = {s: None for s in range(4)}  # slot -> [prompt, first logits, decode rows]
    done = []

    def admit(prompts, slots):
        nonlocal state
        n0 = len(recorded)
        state = _admit(params, state, prompts, slots)
        first = recorded[n0]
        for j, (pr, s) in enumerate(zip(prompts, slots)):
            slot_log[s] = {"prompt": pr, "logits": [first[j]],
                           "tokens": [int(state.token[s])]}

    def segment():
        nonlocal state
        n0 = len(recorded)
        active = state.active.clone()
        state, outs = batching.decode_steps(CFG, SCFG, EOS, 8, params, state)
        for s, log in slot_log.items():
            if log is not None and bool(active[s]):
                log["logits"] += [recorded[n0 + i][s] for i in range(8)]
                log["tokens"] += outs[s].tolist()

    admit([prompt(5), prompt(23)], [0, 2])
    segment()
    admit([prompt(40)], [1])
    segment()
    state = batching.retire_slots(state, torch.tensor([False, False, True, False]))
    done.append(slot_log[2])
    slot_log[2] = None
    admit([prompt(17), prompt(9)], [2, 3])
    segment()
    done += [v for v in slot_log.values() if v is not None]
    assert len(done) == 5
    for log in done:
        ids = log["prompt"] + log["tokens"][:-1]
        want = reference_lfm2.logits(sizes(), params, ids, len(log["prompt"]), kv="int8")
        got = torch.stack(log["logits"])
        assert got.shape == want.shape
        torch.testing.assert_close(got, want, rtol=0, atol=2e-5)


def test_engine_serves_and_counts_expert_rows(params):
    """The Engine end to end over more requests than slots; its tokens are
    the reference's greedy picks, and its stats count the experts' rows."""
    eng = Engine(CFG, params, eos_id=EOS, n_slots=3, sampling=SCFG, segment_steps=8,
                 device="cpu")
    prompts = [[5, 9, 2, 6], [31, 41, 59, 26, 53], [3], [8, 8, 1, 2, 3, 4, 7], [100, 200]]
    budgets = [12, 20, 7, 16, 9]
    rids = [eng.submit(p, max_new=m) for p, m in zip(prompts, budgets)]
    out = eng.run()
    assert [len(out[r]) for r in rids] == budgets
    for r, pr in zip(rids, prompts):
        want = reference_lfm2.logits(sizes(), params, pr + out[r][:-1], len(pr), kv="int8")
        want[:, EOS] = -float("inf")
        gap = want.max(dim=1).values - want[torch.arange(len(out[r])), torch.tensor(out[r])]
        assert float(gap.max()) <= 2e-5
    assert eng.stats["expert_load_peak"] >= 100.0
    counts = eng.state.expert_rows
    assert counts.shape == (CFG.n_moe_layers, 2, CFG.n_experts)
    rows, touched = counts[:, 0], counts[:, 1]
    # every decode row of every step routes top-k pairs in each MoE layer
    steps = eng.stats["dispatched_token_slots"]
    assert torch.all(rows.sum(dim=1) == steps * CFG.n_experts_per_tok)
    # an expert is touched in at most every step, and in some step if it took rows
    n_steps = steps // eng.n_slots
    assert torch.all((touched <= n_steps) & (touched <= rows) & ((rows > 0) <= (touched > 0)))
    assert torch.all(touched.sum(dim=1) >= n_steps * CFG.n_experts_per_tok)


def test_left_padded_conv_state_equals_unpadded(params):
    ids = torch.tensor([[7, 3, 90, 12, 5, 66, 1]], dtype=torch.int32)
    out = {}
    for pad in (0, 9):
        toks = torch.cat([torch.zeros((1, pad), dtype=torch.int32), ids], dim=1)
        states, kv = {}, {}
        h = lfm2.prefill_hidden(CFG, params, toks, torch.tensor([7], dtype=torch.int32),
                                lambda i, k, v: kv.__setitem__(i, (k[:, pad:], v[:, pad:])),
                                lambda i, st: states.__setitem__(i, st))
        out[pad] = (h, states, kv)
    (h0, s0, kv0), (h1, s1, kv1) = out[0], out[9]
    assert set(s0) == set(range(len(CFG.conv_layers)))
    # equal up to the f32 products' summation order over another row count
    for i in s0:
        assert s0[i].shape == (1, CFG.conv_kernel - 1, CFG.hidden_size)
        torch.testing.assert_close(s1[i], s0[i], rtol=1e-5, atol=1e-5)
    for i in kv0:
        torch.testing.assert_close(kv1[i], kv0[i], rtol=0, atol=1e-5)
    torch.testing.assert_close(h1, h0, rtol=0, atol=1e-5)
    # a prompt shorter than the window: the state holds zeros before it
    st = {}
    lfm2.prefill_hidden(CFG, params, torch.tensor([[0, 0, 0, 42]], dtype=torch.int32),
                        torch.tensor([1], dtype=torch.int32), lambda *a: None,
                        lambda i, s: st.__setitem__(i, s))
    assert not st[0][0, 0].any() and st[0][0, 1].any()


def test_expert_bias_moves_the_choice_not_the_weights():
    logits = torch.tensor([[2.0, 1.0, 0.5, -1.0], [0.0, 0.3, -0.2, 0.1]])
    bias = torch.tensor([0.0, 0.0, 0.0, 5.0])
    idx0, w0 = moe_ops.route(logits, None, 2)
    idx1, w1 = moe_ops.route(logits, bias, 2)
    assert idx0[0].tolist() == [0, 1] and idx1[0].tolist() == [3, 0]
    scores = torch.sigmoid(logits)
    for idx, w in ((idx0, w0), (idx1, w1)):
        sel = torch.gather(scores, 1, idx)
        torch.testing.assert_close(w, sel / sel.sum(dim=1, keepdim=True))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_swiglu_plain_matches_a_per_token_loop(dtype):
    gen = torch.Generator().manual_seed(3)
    T, D, Fe, E, k = 19, 32, 24, 6, 2
    x = torch.randn((T, D), generator=gen).to(dtype)
    wg, wu = (torch.randn((E, D, Fe), generator=gen).mul(D ** -0.5).to(dtype) for _ in range(2))
    wd = torch.randn((E, Fe, D), generator=gen).mul(Fe ** -0.5).to(dtype)
    # experts 1 and 4 take no rows
    idx = torch.tensor([[0, 2], [3, 5], [2, 0], [5, 3]] * 4 + [[0, 3], [2, 5], [3, 0]])
    perm, offsets, counts = moe_ops.sort_pairs(idx, E)
    want = [int((idx == e).sum()) for e in range(E)]
    assert counts.tolist() == want and want[1] == want[4] == 0
    assert offsets.tolist() == np.cumsum([0] + want).tolist()
    assert sorted(perm.tolist()) == list(range(T * k))
    assert (idx.reshape(-1)[perm.long()].diff() >= 0).all()
    y = moe_ops.grouped_swiglu(x, perm, offsets, wg, wu, wd, k)
    assert y.shape == (T * k, D) and y.dtype == torch.float32
    for t in range(T):
        for j in range(k):
            e = int(idx[t, j])
            xf = x[t].float()
            hh = (F.silu(xf @ wg[e].float()) * (xf @ wu[e].float())).to(dtype).float()
            torch.testing.assert_close(y[t * k + j], hh @ wd[e].float(), rtol=1e-5, atol=1e-5)


def test_segment_graph_body_keeps_the_conv_state(params):
    """The body a CUDA graph captures, run directly on its static buffers,
    against the eager staged segment over three segments with a retirement
    and an admission: tokens, the KV cache, the conv state and the expert
    counts equal; the graph's buffers include the state's conv tensor."""
    sA = _admit(params, batching.SlotState.create(CFG, 3, "cpu"), [[4, 5, 6], [7, 8]], [0, 1])
    sB = _admit(params, batching.SlotState.create(CFG, 3, "cpu"), [[4, 5, 6], [7, 8]], [0, 1])
    seg = batching._SegmentGraph(CFG, SCFG, EOS, 8, params, sA)
    assert seg.static.conv is sA.conv and seg.static.expert_rows is sA.expert_rows
    assert seg.serves(CFG, SCFG, EOS, params, sA) and not seg.serves(CFG, SCFG, EOS, params, sB)
    for r in range(3):
        if r == 1:
            retire = torch.tensor([True, False, False])
            sA, sB = (batching.retire_slots(s, retire) for s in (sA, sB))
            assert not sA.conv[:, 0].any()
            sA, sB = (_admit(params, s, [[9, 9, 1, 3]], [0]) for s in (sA, sB))
        sA, outA = seg.run(sA, seg.body)
        sB, outB = batching._decode_steps_staged(CFG, SCFG, EOS, 8, params, sB)
        assert torch.equal(outA, outB), r
    assert torch.equal(sA.conv, sB.conv) and sA.conv.any()
    assert torch.equal(sA.expert_rows, sB.expert_rows)
    for f in ("k", "v", "k_scale", "v_scale"):
        assert torch.equal(getattr(sA.cache, f), getattr(sB.cache, f)), f
    assert sA.cache.k.shape[0] == CFG.n_cache_layers == 2


def test_admit_graph_body_keeps_the_conv_state(params):
    """The body an admission's CUDA graph captures, run directly on its
    static buffers, against the eager admission: a group with a duplicate
    slot, then the same shape into other slots: the per-slot tensors, the KV
    cache and the conv state equal; the graph writes the state's own conv
    tensor."""
    sA, sB = (batching.SlotState.create(CFG, 4, "cpu", seed=2) for _ in range(2))
    g = batching._AdmitGraph(CFG, SCFG, EOS, params, sA, 3, 64)
    assert g.static.conv is sA.conv and g.serves(CFG, SCFG, EOS, params, sA)
    for prompts, slots in (([[4, 5, 6], [7, 8], [7, 8]], [0, 2, 2]),
                           ([[9, 9, 1, 3], [2], [5, 5]], [1, 3, 0])):
        toks = torch.zeros((3, 64), dtype=torch.int32)
        for j, pr in enumerate(prompts):
            toks[j, 64 - len(pr):] = torch.tensor(pr)
        inputs = (toks, torch.tensor([len(p) for p in prompts], dtype=torch.int32),
                  torch.tensor(slots, dtype=torch.int32))
        sA, _ = g.run(sA, g.body, *inputs)
        sB = batching._prefill_slots_eager(CFG, SCFG, EOS, params, sB, *inputs)
        for n in batching._SLOT_INPUTS:
            assert torch.equal(getattr(sA, n), getattr(sB, n)), n
    assert torch.equal(sA.conv, sB.conv) and sA.conv.any()
    for f in ("k", "v", "k_scale", "v_scale"):
        assert torch.equal(getattr(sA.cache, f), getattr(sB.cache, f)), f


def test_qwen2_paths_refuse_an_lfm2_config(params):
    toks, lens = dec.pad_prompts([[3, 4, 5]], pad_id=0, bucket=128, device="cpu")
    with pytest.raises(NotImplementedError, match="Qwen2"):
        dec.generate(CFG, SCFG, EOS, 4, params, toks, lens)
    with pytest.raises(NotImplementedError, match="Qwen2"):
        tbb.forward_train(CFG, params, toks, torch.ones_like(toks, dtype=torch.bool))
    from neutts_tpu_torch.parallel import mesh

    with pytest.raises(NotImplementedError, match="Qwen2"):
        mesh.shard_params(params, None, CFG)
    with pytest.raises(ValueError, match="layer_types"):
        config.LFM2_TINY.scaled(n_layers=5)


def test_published_config_shapes():
    c = config.LFM2_8B_A1B
    assert c.attn_layers == (2, 6, 10, 14, 18, 21) and len(c.conv_layers) == 18
    assert c.vocab_size == 131_078 and c.layout.codebook_size == 65_536
    assert (c.n_experts, c.n_experts_per_tok, c.moe_intermediate_size) == (32, 4, 1792)
    assert c.n_cache_layers == 6 and c.n_moe_layers == 22
    assert lfm2.conv_state_shape(c, 256) == (18, 256, 2, 2048)


@pytest.mark.parametrize("kv_dtype", ["int8", "float32"])
def test_qwen2_engine_is_unchanged(kv_dtype):
    """The Qwen2 block's Engine keeps no conv state nor expert counts, and
    serves the lockstep `generate`'s tokens."""
    cfg = config.TINY.scaled(kv_dtype=kv_dtype)
    p = tbb.init_params(cfg, seed=2, device="cpu")
    scfg = config.SamplingConfig(greedy=True, min_new_tokens=2)
    eng = Engine(cfg, p, eos_id=cfg.layout.speech_gen_end, n_slots=2, sampling=scfg,
                 segment_steps=8, device="cpu")
    assert eng.state.conv is None and eng.state.expert_rows is None
    assert eng.state.cache.k.shape[0] == cfg.n_layers
    prompts = [[3, 1, 4, 1, 5], [9, 2, 6, 5], [2, 7, 1]]
    rids = [eng.submit(pr, max_new=16) for pr in prompts]
    out = eng.run()
    assert "expert_load_peak" not in eng.stats
    for rid, pr in zip(rids, prompts):
        toks, lens = dec.pad_prompts([pr], pad_id=0, bucket=128, device="cpu")
        want = dec.extract(dec.generate(cfg, scfg, cfg.layout.speech_gen_end, 16, p, toks, lens),
                           0, cfg.layout.speech_gen_end)
        assert out[rid] == want
