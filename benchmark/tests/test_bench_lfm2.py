"""The LFM2-MoE serving cell at tiny sizes on the CPU: its manifest entries
load, a run is correct and reports, the check fails a run whose timed path
drops a conv-state update or computes a wrong expert row (and the control,
the reference one precision down, reads above the limit), and the grouped
expert kernel's counts hold for a hand-worked case."""

from __future__ import annotations

import copy
import time
import warnings

import pytest
import torch

from benchmark import run as runmod
from benchmark.drivers import engine_lfm2
from benchmark.harness import lfm2, manifest
from benchmark.harness.manifest import BENCH_DIR, Cell
from benchmark.tests import tiny

CPU = torch.device("cpu")
SEEDS = (11, 4_294_967_311)
TINY_LFM2 = {"hidden_size": 64, "num_hidden_layers": 6, "num_attention_heads": 4,
             "num_key_value_heads": 2, "head_dim": 16, "intermediate_size": 128,
             "moe_intermediate_size": 32, "num_experts": 8, "num_experts_per_tok": 2,
             "layer_types": ["conv", "conv", "full_attention", "conv", "full_attention", "conv"],
             "max_context": 512, "text_tokens": 320, "special_tokens": 6, "codebook_size": 64,
             "extended_vocab_size": 390, "compute_dtype": "float32"}


@pytest.fixture(autouse=True)
def _quiet():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        yield


def tiny_cell() -> Cell:
    c = copy.deepcopy(tiny._load("configs/lfm2-8b-a1b-bf16-int8kv.json"))
    c.update(TINY_LFM2)
    c["name"] += "-tiny"
    c["limits"] = {"token_gap": tiny.TINY_LIMITS["token_gap"]}
    t = tiny._load("traffic/serve-backlog-lfm2.json")
    t.update(name="serve-backlog-lfm2-tiny", n_slots=8, segment_steps=8, prompt_tokens=[20, 60],
             budget=[10, 30], n_requests=4000, check_requests=4, backlog=8,
             first_wave_budget=[1, 30], warm_segments=1)
    real = manifest.load_cell("serve-lfm2-backlog")
    return Cell(name="serve-lfm2-backlog", chips=1, config=c, traffic=t,
                end_to_end=real.end_to_end, per_layer=real.per_layer)


def test_manifest_entries_load():
    cell = manifest.load_cell("serve-lfm2-backlog")
    assert cell.chips == 1 and cell.config["num_experts"] == 32
    assert manifest.driver(cell.traffic) is engine_lfm2
    assert {m["name"] for m in cell.end_to_end} == {"speech_tokens_per_s", "setup_s"}
    names = {m["name"] for m in cell.per_layer}
    assert names == {"kernel.moe_experts.roofline.lfm2", "moe.expert_load_peak.lfm2",
                     "model.mfu.lfm2", "device.idle_share.lfm2", "engine.dispatch_ms.lfm2",
                     "decode.graph_share.lfm2", "engine.useful_share.lfm2", "engine.admit_ms.lfm2",
                     "engine.prefill_useful_share.lfm2", "readback.wait_ms.lfm2",
                     "kernel.staged_attention.roofline.lfm2"}
    assert manifest.reader_path("model.mfu.lfm2").name == "model.mfu.py"
    assert manifest.reader_path("kernel.moe_experts.roofline.lfm2").name == \
        "kernel.moe_experts.roofline.py"
    # the file keeps the catalog's published numbers under their names
    c = cell.config
    assert (c["vocab_size"], c["hidden_size"], c["moe_intermediate_size"],
            c["intermediate_size"], c["norm_eps"]) == (65536, 2048, 1792, 7168, 1e-5)
    cfg = lfm2.backbone_config(c)
    assert cfg.vocab_size == c["extended_vocab_size"] == 131_078
    assert cfg.attn_layers == (2, 6, 10, 14, 18, 21)
    assert (BENCH_DIR / "reference" / "lfm2.py").exists()


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
    rec = engine_lfm2.run(c, seed, 2.0, False, CPU, time.perf_counter())
    v = engine_lfm2.compare(rec, seed, CPU, control=c.config["control"])
    assert v["token_gap"] <= c.config["limits"]["token_gap"] < v["control_token_gap"], v


def _fault(monkeypatch, fault: str):
    from neutts_tpu_torch.models import lfm2 as port
    from neutts_tpu_torch.ops import moe as moe_ops

    if fault == "conv state not updated":
        orig = port.conv_step

        def conv_step(lp, h, state):
            keep = state.clone()
            out = orig(lp, h, state)
            state.copy_(keep)
            return out

        monkeypatch.setattr(port, "conv_step", conv_step)
    elif fault == "wrong expert row":  # each token's first pair takes its second's row
        orig = moe_ops.grouped_swiglu_plain

        def grouped(x, perm, offsets, wg, wu, wd, top_k):
            y = orig(x, perm, offsets, wg, wu, wd, top_k).view(-1, top_k, x.shape[1])
            y[:, 0] = y[:, 1]
            return y.view(-1, x.shape[1])

        monkeypatch.setattr(moe_ops, "grouped_swiglu_plain", grouped)


@pytest.mark.parametrize("fault", ["conv state not updated", "wrong expert row"])
def test_a_broken_timed_path_is_not_correct(monkeypatch, fault):
    c = tiny_cell()
    seed = SEEDS[0]
    with monkeypatch.context() as mp:
        _fault(mp, fault)
        rec = engine_lfm2.run(c, seed, 2.0, False, CPU, time.perf_counter())
    v = engine_lfm2.compare(rec, seed, CPU)
    assert v["token_gap"] > c.config["limits"]["token_gap"], v


def test_expert_counts_by_hand():
    m = lfm2.sizes(manifest.load_cell("serve-lfm2-backlog").config)
    # one expert: gate, up and down of 2,048 x 1,792 bf16
    assert lfm2.expert_matrix_bytes(m) == 3 * 2048 * 1792 * 2 == 22_020_096
    # a decode step at 256 slots: 1,024 pairs, all 32 experts touched
    assert lfm2.expert_flops(m, 1024) == 2 * 3 * 2048 * 1792 * 1024
    assert lfm2.expert_bytes(m, 32, 1024) == 32 * 22_020_096 + 1024 * (2 * 2048 + 4 * 2048)
    # memory bound there: 0.214 ms of bytes against 0.0228 ms of FLOPs
    from benchmark.harness import counts

    b = lfm2.expert_bytes(m, 32, 1024)
    assert counts.bound_s(lfm2.expert_flops(m, 1024), b, counts.PEAK_BF16) == \
        b / counts.HBM_BYTES_PER_S
    # a token: 18 conv, 6 attention, 2 dense and 22 MoE layers (4 of 32 experts)
    D = 2048
    per = (18 * (D * 3 * D + 3 * D + D * D) + 6 * (D * 2048 + 2 * D * 512 + 2048 * D)
           + 2 * 3 * D * 7168 + 22 * (D * 32 + 4 * 3 * D * 1792))
    assert lfm2.flops_per_token(m, 0) == 2.0 * per
    assert lfm2.attention_flops(m, 10) == 4.0 * 6 * 32 * 64 * 10
