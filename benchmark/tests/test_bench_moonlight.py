"""The Moonlight serving cell at tiny sizes on the CPU: its manifest entries
load, a run is correct and reports, the check fails a run whose timed path
drops a latent row or takes the routed scale off (and the control, the
reference one precision down, reads above the limit), and the counts of the
model, the MLA decode kernel and the experts hold for hand-worked cases."""

from __future__ import annotations

import copy
import math
import time
import warnings

import pytest
import torch

from benchmark import run as runmod
from benchmark.drivers import engine_moonlight
from benchmark.harness import manifest, moonlight
from benchmark.harness.manifest import BENCH_DIR, Cell
from benchmark.tests import tiny

CPU = torch.device("cpu")
SEEDS = (11, 4_294_967_311)
CELL = "serve-moonlight-longform"
TINY_MOONLIGHT = {"hidden_size": 64, "num_hidden_layers": 3, "num_attention_heads": 4,
                  "num_key_value_heads": 4, "kv_lora_rank": 64, "qk_nope_head_dim": 32,
                  "qk_rope_head_dim": 16, "v_head_dim": 32, "intermediate_size": 128,
                  "moe_intermediate_size": 32, "n_routed_experts": 8, "num_experts_per_tok": 2,
                  "n_shared_experts": 1, "max_context": 512, "text_tokens": 320,
                  "special_tokens": 6, "codebook_size": 64, "extended_vocab_size": 390,
                  "compute_dtype": "float32"}


@pytest.fixture(autouse=True)
def _quiet():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        yield


def tiny_cell() -> Cell:
    c = copy.deepcopy(tiny._load("configs/moonlight-16b-a3b-bf16-int8latent.json"))
    c.update(TINY_MOONLIGHT)
    c["name"] += "-tiny"
    c["limits"] = {"token_gap": tiny.TINY_LIMITS["token_gap"]}
    t = tiny._load("traffic/serve-longform-moonlight.json")
    t.update(name="serve-longform-moonlight-tiny", n_slots=8, segment_steps=8,
             prompt_tokens=[20, 60], budget=[10, 30], n_requests=4000, check_requests=4,
             backlog=8, first_wave_budget=[1, 30], warm_segments=1)
    real = manifest.load_cell(CELL)
    return Cell(name=CELL, chips=1, config=c, traffic=t, end_to_end=real.end_to_end,
                per_layer=real.per_layer)


def test_manifest_entries_load():
    cell = manifest.load_cell(CELL)
    assert cell.chips == 1 and manifest.driver(cell.traffic) is engine_moonlight
    assert {m["name"] for m in cell.end_to_end} == {"speech_tokens_per_s", "setup_s"}
    names = {m["name"] for m in cell.per_layer}
    assert names == {"kernel.mla_decode.roofline.moonlight",
                     "kernel.moe_experts.roofline.moonlight", "moe.expert_load_peak.moonlight",
                     "model.mfu.moonlight", "device.idle_share.moonlight",
                     "decode.graph_share.moonlight", "engine.admit_graph_share.moonlight",
                     "engine.dispatch_ms.moonlight", "engine.useful_share.moonlight",
                     "engine.admit_ms.moonlight", "engine.prefill_useful_share.moonlight",
                     "readback.wait_ms.moonlight"}
    for metric, reader in (("kernel.mla_decode.roofline.moonlight", "kernel.mla_decode.roofline"),
                           ("kernel.moe_experts.roofline.moonlight",
                            "kernel.moe_experts.roofline"),
                           ("model.mfu.moonlight", "model.mfu"),
                           ("device.idle_share.moonlight", "device.idle_share"),
                           ("engine.useful_share.moonlight", "engine.useful_share"),
                           ("engine.admit_ms.moonlight", "engine.admit_ms"),
                           ("engine.prefill_useful_share.moonlight",
                            "engine.prefill_useful_share"),
                           ("readback.wait_ms.moonlight", "readback.wait_ms")):
        assert manifest.reader_path(metric).name == reader + ".py"
    # the file keeps the published numbers under their names
    c = cell.config
    assert (c["hidden_size"], c["num_hidden_layers"], c["n_routed_experts"],
            c["num_experts_per_tok"], c["n_shared_experts"], c["moe_intermediate_size"],
            c["intermediate_size"], c["kv_lora_rank"], c["qk_rope_head_dim"],
            c["num_attention_heads"], c["vocab_size"]) == (
        2048, 27, 64, 6, 2, 1408, 11264, 512, 64, 16, 163840)
    assert c["routed_scaling_factor"] == 2.446 and c["reduced"] == ["sampling"]
    cfg = moonlight.backbone_config(c)
    assert cfg.vocab_size == c["extended_vocab_size"] == 229_382
    assert (cfg.latent_dim, cfg.n_moe_layers, cfg.max_context) == (576, 26, 4096)
    assert (BENCH_DIR / "reference" / "moonlight.py").exists()


def test_routing_code_has_mean_zero():
    """The seeded weights' routing code: +1 on k experts of each token id
    and -k / (E - k) on the rest, so each code dim averages 0 over the ids
    and adds no vector common to every token; no layer writes the code dims
    and the head never reads them; the router reads code dim s alone."""
    m = moonlight.sizes({**manifest.load_cell(CELL).config, **TINY_MOONLIGHT})
    D, E, k = m["hidden_size"], m["n_routed_experts"], m["num_experts_per_tok"]
    p = moonlight.params(m, SEEDS[1], CPU, torch.float32)
    code = p["embed"][:, D - E:]
    assert ((code == 1.0).sum(dim=1) == k).all()
    assert torch.allclose(code[code != 1.0], torch.tensor(-k / (E - k)))
    assert code.mean(dim=0).abs().max() < 0.05  # 390 ids: the draw's spread alone
    assert code.sum().abs() < 1e-3  # k x 1 - (E - k) x k / (E - k) = 0 in every row
    for w in (p["attn"]["wo"], p["dense"]["w_down"], p["moe"]["w_down"],
              p["shared"]["w_down"]):
        assert not w[..., D - E:].any()
    assert not p["final_norm"][D - E:].any()
    router = p["moe"]["router"]
    assert not router[:, :D - E].any()
    assert ((router[:, D - E:] != 0).sum(dim=2) == 1).all()
    assert ((router[:, D - E:] != 0).sum(dim=1) == 1).all()


def test_tiny_run_is_correct_and_reports():
    c = tiny_cell()
    res = runmod.measure(c, 3_000_000_019, 3.0, False, CPU, time.perf_counter())
    assert res["correct"] is True, res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert set(res["metrics"]) == {"speech_tokens_per_s", "setup_s"}
    assert list(res)[-1] == "checks" and set(res["checks"]) == {"token_gap"}


@pytest.mark.parametrize("seed", SEEDS)
def test_control_fails_the_token_gap(seed):
    c = tiny_cell()
    rec = engine_moonlight.run(c, seed, 2.0, False, CPU, time.perf_counter())
    v = engine_moonlight.compare(rec, seed, CPU, control=c.config["control"])
    assert v["token_gap"] <= c.config["limits"]["token_gap"] < v["control_token_gap"], v


def _fault(monkeypatch, fault: str):
    from neutts_tpu_torch.ops import attention as attn_ops
    from neutts_tpu_torch.ops import moe as moe_ops

    if fault == "latent row dropped":  # a segment's first latent row never reaches the cache
        orig = attn_ops.reconcile_segment_plain

        def reconcile(all_k, all_v, k_scale, v_scale, stag_k, stag_v, stag_ks, stag_vs, base,
                      active):
            stag_k = stag_k.clone()
            stag_k[:, :, 0] = 0
            return orig(all_k, all_v, k_scale, v_scale, stag_k, stag_v, stag_ks, stag_vs, base,
                        active)

        monkeypatch.setattr(attn_ops, "reconcile_segment_plain", reconcile)
    elif fault == "routed scale taken off":
        orig = moe_ops.route
        monkeypatch.setattr(moe_ops, "route",
                            lambda logits, bias, k, scale=1.0: orig(logits, bias, k))


@pytest.mark.parametrize("fault", ["latent row dropped", "routed scale taken off"])
def test_a_broken_timed_path_is_not_correct(monkeypatch, fault):
    c = tiny_cell()
    seed = SEEDS[0]
    with monkeypatch.context() as mp:
        _fault(mp, fault)
        rec = engine_moonlight.run(c, seed, 2.0, False, CPU, time.perf_counter())
    v = engine_moonlight.compare(rec, seed, CPU)
    assert v["token_gap"] > c.config["limits"]["token_gap"], v


def test_counts_by_hand():
    m = moonlight.sizes(manifest.load_cell(CELL).config)
    D, H, L = 2048, 16, 27
    # one routed expert: gate, up and down of 2,048 x 1,408 bf16
    assert moonlight.expert_matrix_bytes(m) == 3 * D * 1408 * 2 == 17_301_504
    # the MLA decode kernel: a latent row of 576 int8 values and its scale
    # for each attended key; each query's bf16 [16, 576] in, [16, 512] out
    assert moonlight.latent_row(m) == 576
    assert moonlight.mla_decode_bytes(m, 10, 1) == 10 * 580 + H * (576 + 512) * 2
    assert moonlight.mla_decode_flops(m, 10) == 2.0 * L * H * (576 + 512) * 10
    # one decode token: MLA's projections with the absorb products, 1 dense
    # and 26 expert layers (6 of 64 routed, 2 shared of 1,408 as one 2,816)
    mla = D * H * 192 + D * 576 + H * 128 * D + H * (128 * 512 + 512 * 128)
    per = L * mla + 3 * D * 11264 + 26 * (D * 64 + 6 * 3 * D * 1408 + 3 * D * 2816)
    assert moonlight.flops_per_token(m, 0) == 2.0 * per
    prefill_mla = D * H * 192 + D * 576 + H * 128 * D + 512 * H * 256
    assert moonlight.flops_per_token(m, 0, decode=False) == 2.0 * (
        per - L * mla + L * prefill_mla)
    # the whole model: 16.23B parameters, 32.5 GB in bf16
    n = sum(math.prod(s) for _, s, _, _ in moonlight.specs(m))
    assert 16.2e9 < n < 16.3e9
    # a decode step at 256 slots: 1,536 routed pairs, ~24 rows an expert
    assert moonlight.expert_flops(m, 256 * 6) == 2 * 3 * D * 1408 * 1536
