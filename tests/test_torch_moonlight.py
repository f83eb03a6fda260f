"""The Moonlight backbone in the port's serving engine (models/moonlight.py,
ops/attention.py's MLA decode, the latent cache of models/backbone.py,
runtime/batching.py's block interface), on the CPU at a tiny seeded size,
against the plain float32 reference `tests/reference_moonlight.py` (no
port code).

The engine's prefill (the non-absorbed form) then staged decode (the
absorbed form over the int8 latent cache), across segments with
admissions and retirements, is compared with the reference's full forward
pass on logits; the absorbed decode equals the non-absorbed form on the
same latent; the rope permutation equals the interleaved rotation; the
router's scale and the shared experts; the MLA decode's plain version
against the reference's attention; the Qwen2-only paths refuse the config.

Tolerances: the engine and the reference compute the same f32 function in
another order (absorbed against non-absorbed products, batched against
per-sequence sums), which moves a logit by ~1e-6; 2e-5 leaves room for
that and for an int8 latent value that the two round to neighbouring
steps, while a missing latent row, routed scale or shared expert moves
logits by 1e-3 and more.
"""

import numpy as np
import pytest
import torch

from neutts_tpu_torch import config
from neutts_tpu_torch.models import backbone as tbb
from neutts_tpu_torch.models import moonlight
from neutts_tpu_torch.ops import attention as attn_ops
from neutts_tpu_torch.ops import moe as moe_ops
from neutts_tpu_torch.ops import sampling as smp
from neutts_tpu_torch.runtime import batching
from neutts_tpu_torch.runtime import decode as dec
from neutts_tpu_torch.serving import Engine

import _torch_threads  # noqa: F401  (pins torch's threads in this process)
import reference_moonlight as ref

CFG = config.MOONLIGHT_TINY
EOS = CFG.layout.speech_gen_end
# greedy over the whole vocabulary, EOS held off: every step serves a token
SCFG = config.SamplingConfig(greedy=True, min_new_tokens=10_000)


def sizes(cfg=CFG) -> dict:
    return {"hidden_size": cfg.hidden_size, "num_hidden_layers": cfg.n_layers,
            "num_attention_heads": cfg.n_heads, "kv_lora_rank": cfg.kv_lora_rank,
            "qk_nope_head_dim": cfg.qk_nope_head_dim, "qk_rope_head_dim": cfg.qk_rope_head_dim,
            "v_head_dim": cfg.v_head_dim, "n_routed_experts": cfg.n_experts,
            "num_experts_per_tok": cfg.n_experts_per_tok,
            "first_k_dense_replace": cfg.n_dense_layers, "norm_topk_prob": True,
            "routed_scaling_factor": cfg.routed_scaling_factor, "rope_theta": cfg.rope_theta,
            "rms_norm_eps": cfg.rms_norm_eps, "vocab_size": cfg.vocab_size}


@pytest.fixture(scope="module")
def raw():
    """Seeded weights in the published layout, whose norm gains and
    correction bias are not the identity."""
    p = moonlight.init_params(CFG, seed=5, device="cpu")
    gen = torch.Generator().manual_seed(6)
    for t in (p["layers"]["attn_norm"], p["layers"]["ffn_norm"], p["attn"]["kv_norm"],
              p["final_norm"]):
        t.add_(0.1 * torch.randn(t.shape, generator=gen))
    p["moe"]["expert_bias"].copy_(0.1 * torch.randn(p["moe"]["expert_bias"].shape,
                                                    generator=gen))
    return p


@pytest.fixture(scope="module")
def params(raw):
    return moonlight.prepare_params(CFG, raw)


def _admit(params, state, prompts, slots, Lp=64):
    toks = np.zeros((len(prompts), Lp), np.int32)
    for j, pr in enumerate(prompts):
        toks[j, Lp - len(pr):] = pr
    return batching.prefill_slots(CFG, SCFG, EOS, params, state, torch.from_numpy(toks),
                                  torch.tensor([len(p) for p in prompts], dtype=torch.int32),
                                  torch.tensor(slots, dtype=torch.int32))


def test_engine_prefill_and_decode_match_the_reference_on_logits(raw, params, monkeypatch):
    """Three segments over 4 slots: two admissions, a retirement and a
    re-admission into the retired slot. Every logit row the engine sampled
    from equals the reference's at that position, the decode's through the
    int8 latent rows."""
    recorded = []
    orig = smp.sample_from_hidden

    def sample_from_hidden(cfg, sampling, p, x, gen, eos_id, suppress):
        recorded.append(tbb._logits(cfg, p, x, trim=True))
        return orig(cfg, sampling, p, x, gen, eos_id, suppress)

    monkeypatch.setattr(smp, "sample_from_hidden", sample_from_hidden)
    rng = np.random.default_rng(0)
    prompt = lambda n: rng.integers(0, CFG.vocab_size - 1, n).tolist()  # noqa: E731
    state = batching.SlotState.create(CFG, 4, "cpu")
    assert state.cache.latent and state.cache.v is None and state.conv is None
    assert state.cache.k.shape == (CFG.n_layers, 4, batching.slot_cache_len(CFG), 80)
    slot_log = {s: None for s in range(4)}
    done = []

    def admit(prompts, slots):
        nonlocal state
        n0 = len(recorded)
        state = _admit(params, state, prompts, slots)
        first = recorded[n0]
        for j, (pr, s) in enumerate(zip(prompts, slots)):
            slot_log[s] = {"prompt": pr, "logits": [first[j]], "tokens": [int(state.token[s])]}

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
        want = ref.logits(sizes(), raw, ids, len(log["prompt"]), kv="int8")
        got = torch.stack(log["logits"])
        assert got.shape == want.shape
        torch.testing.assert_close(got, want, rtol=0, atol=2e-5)


def test_engine_serves_and_counts_expert_rows(raw):
    """The Engine end to end over more requests than slots; its tokens are
    the reference's greedy picks (within the tolerance), and its stats count
    the 2 MoE layers' rows."""
    eng = Engine(CFG, raw, eos_id=EOS, n_slots=3, sampling=SCFG, segment_steps=8, device="cpu")
    prompts = [[5, 9, 2, 6], [31, 41, 59, 26, 53], [3], [8, 8, 1, 2, 3, 4, 7], [100, 200]]
    budgets = [12, 20, 7, 16, 9]
    rids = [eng.submit(p, max_new=m) for p, m in zip(prompts, budgets)]
    out = eng.run()
    assert [len(out[r]) for r in rids] == budgets
    for r, pr in zip(rids, prompts):
        want = ref.logits(sizes(), raw, pr + out[r][:-1], len(pr), kv="int8")
        want[:, EOS] = -float("inf")
        gap = want.max(dim=1).values - want[torch.arange(len(out[r])), torch.tensor(out[r])]
        assert float(gap.max()) <= 2e-5
    counts = eng.state.expert_rows
    assert counts.shape == (CFG.n_moe_layers, 2, CFG.n_experts) == (2, 2, 8)
    steps = eng.stats["dispatched_token_slots"]
    assert torch.all(counts[:, 0].sum(dim=1) == steps * CFG.n_experts_per_tok)
    assert eng.stats["expert_load_peak"] >= 100.0


def test_absorbed_decode_equals_the_non_absorbed_form(params):
    """One layer's attention over the same int8 latent rows: the absorbed
    form (the latent query, the MLA decode's plain version, the un-absorb
    product) against per-head keys and values made from the rows."""
    gen = torch.Generator().manual_seed(1)
    H, dn, dr, dv, r = (CFG.n_heads, CFG.qk_nope_head_dim, CFG.qk_rope_head_dim,
                        CFG.v_head_dim, CFG.kv_lora_rank)
    B, T, S, step = 3, 20, 8, 5
    lp = moonlight.layer_params(CFG, params)[1]
    rows = torch.randn((1, B, T, r + dr), generator=gen)
    lat, lat_s = tbb.quantize_kv(rows)
    stag_rows = torch.randn((1, B, S, r + dr), generator=gen)
    stag, ss = tbb.quantize_kv(stag_rows)
    stag_s = torch.zeros((1, B, attn_ops.SEG_PAD))
    stag_s[..., :S] = ss
    base = torch.tensor([20, 7, 0], dtype=torch.int32)
    pad = torch.tensor([0, 3, 0], dtype=torch.int32)
    q = torch.randn((B, H, dn + dr), generator=gen)
    q_lat = tbb.bmm_f32(q[..., :dn].transpose(0, 1), lp["w_ukt"]).transpose(0, 1)
    o_lat = attn_ops.mla_decode_staged(torch.cat([q_lat, q[..., dn:]], -1), lat, lat_s, stag,
                                       stag_s, 0, step, base, pad, CFG.softmax_scale, r)
    got = tbb.bmm_f32(o_lat.transpose(0, 1), lp["w_uv"]).transpose(0, 1)
    # the non-absorbed form, row by row
    deq = torch.cat([lat[0].float() * lat_s[0][..., None],
                     stag[0].float() * ss[0][..., None]], dim=1)
    for b in range(B):
        keep = [t for t in range(T) if pad[b] <= t < base[b]] + [T + j for j in range(step + 1)]
        c, k_pe = deq[b, keep, :r], deq[b, keep, r:]
        kv = (c @ lp["wkvb"]).view(len(keep), H, dn + dv)
        k = torch.cat([kv[..., :dn], k_pe[:, None].expand(-1, H, dr)], dim=-1)
        p = torch.softmax(torch.einsum("hd,thd->ht", q[b], k) * CFG.softmax_scale, dim=-1)
        want = torch.einsum("ht,thd->hd", p, kv[..., dn:])
        torch.testing.assert_close(got[b], want, rtol=0, atol=1e-5)


def test_prefill_in_row_chunks_equals_one_pass(params, monkeypatch):
    """An admission group taken through each layer PREFILL_TOKENS tokens of
    whole rows at a time (5 rows of 24 in chunks of 2, 2 and 1) gives the
    hidden state and latent rows of one pass over the group: prompts are
    independent rows."""
    gen = torch.Generator().manual_seed(3)
    B, Lp = 5, 24
    tokens = torch.randint(CFG.layout.speech_base, CFG.vocab_size, (B, Lp), generator=gen,
                           dtype=torch.int32)
    lens = torch.tensor([24, 20, 3, 17, 24], dtype=torch.int32)

    def run():
        kept = {}
        h = moonlight.prefill_hidden(CFG, params, tokens, lens,
                                     lambda l, rows, _: kept.__setitem__(l, rows))
        return h, kept

    h1, kept1 = run()
    monkeypatch.setattr(moonlight, "PREFILL_TOKENS", 2 * Lp + 5)
    h2, kept2 = run()
    torch.testing.assert_close(h2, h1, rtol=1e-6, atol=1e-6)
    for l in range(CFG.n_layers):
        torch.testing.assert_close(kept2[l], kept1[l], rtol=1e-6, atol=1e-6)


def test_rope_permutation_matches_the_interleaved_form(raw, params):
    """The program's projections (rope columns permuted once, half-split
    RoPE) give the reference's rotated q_pe and k_pe (interleaved pairs,
    de-interleaved by the rotation) and the same latent rows."""
    gen = torch.Generator().manual_seed(2)
    N = 9
    h = torch.randn((1, N, CFG.hidden_size), generator=gen)
    pos = torch.arange(N)
    lp = moonlight.layer_params(CFG, params)[0]
    cos, sin = tbb.rope_tables(CFG.qk_rope_head_dim, CFG.rope_theta, pos[None])
    q, rows = moonlight._project(CFG, lp, h, cos, sin)
    dn, dr, r = CFG.qk_nope_head_dim, CFG.qk_rope_head_dim, CFG.kv_lora_rank
    _, want_rows = ref.mla(sizes(), raw["attn"], 0, h[0], pos)
    q_ref = (h[0] @ raw["attn"]["wq"][0]).view(N, CFG.n_heads, dn + dr)
    q_pe = ref.rope_interleaved(q_ref[..., dn:], pos, CFG.rope_theta)
    torch.testing.assert_close(q[0, :, :, dn:], q_pe, rtol=0, atol=1e-5)
    torch.testing.assert_close(q[0, :, :, :dn], q_ref[..., :dn], rtol=0, atol=1e-5)
    torch.testing.assert_close(rows[0], want_rows, rtol=0, atol=1e-5)
    # without the permutation the rotated pairs differ
    assert not torch.allclose(ref.rope_interleaved(q_ref[..., dn:], pos, CFG.rope_theta),
                              tbb.apply_rope(q_ref[..., dn:], cos[0], sin[0]), atol=1e-3)


def test_route_scale_and_shared_experts(params):
    logits = torch.tensor([[2.0, 1.0, 0.5, -1.0], [0.0, 0.3, -0.2, 0.1]])
    idx1, w1 = moe_ops.route(logits, None, 2)
    idx2, w2 = moe_ops.route(logits, None, 2, scale=2.446)
    assert torch.equal(idx1, idx2)
    torch.testing.assert_close(w2, w1 * 2.446)
    torch.testing.assert_close(w1.sum(dim=1), torch.ones(2))
    # an expert layer's FFN: routed experts (scaled) plus the shared SwiGLU
    lp = moonlight.layer_params(CFG, params)[2]
    gen = torch.Generator().manual_seed(3)
    x = torch.randn((2, 5, CFG.hidden_size), generator=gen)
    got = moonlight._ffn(CFG, lp, x) - x
    h = ref.rms(x.reshape(-1, CFG.hidden_size), lp["ffn_norm"], CFG.rms_norm_eps)
    w = {"moe": {k[4:]: v[None] for k, v in lp.items() if k.startswith("moe_")},
         "shared": {k[7:]: v[None] for k, v in lp.items() if k.startswith("shared_")}}
    want = ref.moe(sizes(), w, 0, h).reshape(x.shape)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    shared = ref.swiglu(h, lp["shared_w_gate"], lp["shared_w_up"], lp["shared_w_down"])
    assert float((want - shared.reshape(x.shape)).abs().max()) > 1e-3  # the routed part counts


def test_mla_plain_matches_the_reference_attention(raw):
    """The MLA decode's plain version, over one sequence's quantized latent
    rows with its query in the absorbed form, gives the reference's
    attention (`reference_moonlight.mla` with kv="int8") at the last
    position."""
    gen = torch.Generator().manual_seed(4)
    N = 12
    h = torch.randn((N, CFG.hidden_size), generator=gen)
    pos = torch.arange(N)
    m = sizes()
    want, rows = ref.mla(m, raw["attn"], 0, h, pos, kv="int8", decode_from=0)
    H, dn, dr, dv, r = (CFG.n_heads, CFG.qk_nope_head_dim, CFG.qk_rope_head_dim,
                        CFG.v_head_dim, CFG.kv_lora_rank)
    a = raw["attn"]
    q = (h[-1:] @ a["wq"][0]).view(1, H, dn + dr)
    q_pe = ref.rope_interleaved(q[..., dn:], pos[-1:], CFG.rope_theta)
    kvb = a["wkvb"][0].view(r, H, dn + dv)
    q_lat = torch.einsum("bhd,rhd->bhr", q[..., :dn], kvb[..., :dn])
    lat, lat_s = tbb.quantize_kv(rows[None, None, : N - 1])
    stag, ss = tbb.quantize_kv(rows[None, None, N - 1:])
    stag_s = torch.zeros((1, 1, attn_ops.SEG_PAD))
    stag_s[..., :1] = ss
    o_lat = attn_ops.mla_decode_staged_plain(
        torch.cat([q_lat, q_pe], -1), lat, lat_s, stag, stag_s, 0, 0,
        torch.tensor([N - 1], dtype=torch.int32), torch.tensor([0], dtype=torch.int32),
        CFG.softmax_scale, r)
    o = torch.einsum("bhr,rhd->bhd", o_lat, kvb[..., dn:]).reshape(1, H * dv)
    torch.testing.assert_close(o @ a["wo"][0], want[-1:], rtol=0, atol=1e-5)


def test_graph_bodies_keep_the_latent_cache(params):
    """The bodies the segment and admission CUDA graphs capture, run
    directly on their static buffers, against the eager segment and
    admission: tokens, the latent cache and the expert counts equal; the
    graphs' buffers hold the one latent buffer and no V."""
    sA = _admit(params, batching.SlotState.create(CFG, 3, "cpu"), [[4, 5, 6], [7, 8]], [0, 1])
    sB = _admit(params, batching.SlotState.create(CFG, 3, "cpu"), [[4, 5, 6], [7, 8]], [0, 1])
    seg = batching._SegmentGraph(CFG, SCFG, EOS, 8, params, sA)
    adm = batching._AdmitGraph(CFG, SCFG, EOS, params, sA, 1, 64)
    assert seg.static.cache.k is sA.cache.k and seg.static.cache.v is None
    assert seg.static.expert_rows is sA.expert_rows
    toks = torch.zeros((1, 64), dtype=torch.int32)
    toks[0, -4:] = torch.tensor([9, 9, 1, 3])
    inputs = (toks, torch.tensor([4], dtype=torch.int32), torch.tensor([0], dtype=torch.int32))
    for r in range(3):
        if r == 1:
            retire = torch.tensor([True, False, False])
            sA, sB = (batching.retire_slots(s, retire) for s in (sA, sB))
            sA, _ = adm.run(sA, adm.body, *inputs)
            sB = batching._prefill_slots_eager(CFG, SCFG, EOS, params, sB, *inputs)
        sA, outA = seg.run(sA, seg.body)
        sB, outB = batching._decode_steps_staged(CFG, SCFG, EOS, 8, params, sB)
        assert torch.equal(outA, outB), r
    assert torch.equal(sA.expert_rows, sB.expert_rows) and sA.expert_rows.any()
    for f in ("k", "k_scale"):
        assert torch.equal(getattr(sA.cache, f), getattr(sB.cache, f)), f
    assert sA.cache.v is None and sA.cache.v_scale is None


def test_qwen2_paths_refuse_a_moonlight_config(params):
    toks, lens = dec.pad_prompts([[3, 4, 5]], pad_id=0, bucket=128, device="cpu")
    with pytest.raises(NotImplementedError, match="Qwen2"):
        dec.generate(CFG, SCFG, EOS, 4, params, toks, lens)
    with pytest.raises(NotImplementedError, match="Qwen2"):
        tbb.forward_train(CFG, params, toks, torch.ones_like(toks, dtype=torch.bool))
    from neutts_tpu_torch.parallel import mesh

    with pytest.raises(NotImplementedError, match="Qwen2"):
        mesh.shard_params(params, None, CFG)
    with pytest.raises(ValueError, match="latent cache is int8"):
        batching.SlotState.create(CFG.scaled(kv_dtype="bfloat16"), 2, "cpu")
    with pytest.raises(ValueError, match="prepare_params"):
        moonlight.layer_params(CFG, moonlight.init_params(CFG, seed=0, device="cpu"))


def test_published_config_shapes():
    c = config.MOONLIGHT_16B_A3B
    assert c.vocab_size == 229_382 and c.layout.codebook_size == 65_536
    assert (c.n_experts, c.n_experts_per_tok, c.moe_intermediate_size) == (64, 6, 1408)
    assert (c.kv_lora_rank, c.qk_rope_head_dim, c.latent_dim, c.qk_head_dim) == (512, 64, 576, 192)
    assert c.n_moe_layers == 26 and moonlight.shared_width(c) == 2816
    assert batching.slot_cache_len(c) == 4352
    assert batching.block(c) is moonlight and batching.block(config.AIR).__name__.endswith("qwen2")
    shapes = moonlight.state_shapes(c, 256)
    assert shapes == {"expert_rows": ((26, 2, 64), torch.int64)}
