"""The multi-card serving cell at tiny sizes on the CPU (two replicas on the
CPU): its manifest entry loads, a run's result has the contract's shape and
is correct, the check draws requests from every replica, and the per-card
readers average the cards instead of taking their union."""

from __future__ import annotations

import time
import warnings

import pytest
import torch

from benchmark import run as runmod
from benchmark.drivers import multichip
from benchmark.harness import manifest
from benchmark.harness.manifest import Cell
from benchmark.tests import tiny

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _quiet():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        yield


def tiny_cell() -> Cell:
    real = manifest.load_cell("multichip-w8a8-backlog")
    t = tiny._load("traffic/serve-backlog-4chip.json")
    t.update(name="serve-backlog-4chip-tiny", replicas=2, n_slots=4, segment_steps=8,
             prompt_tokens=[20, 60], budget=[10, 30], n_requests=4000, check_requests=4,
             per_replica_check=2, backlog=8, first_wave_budget=[1, 30], warm_segments=1)
    return Cell(name=real.name, chips=real.chips, config=tiny.config("air-w8a8-int8kv"),
                traffic=t, end_to_end=real.end_to_end, per_layer=real.per_layer)


def test_manifest_entry_loads():
    cell = manifest.load_cell("multichip-w8a8-backlog")
    assert cell.chips == 4 and cell.traffic["replicas"] == 4
    assert manifest.driver(cell.traffic) is multichip
    assert {m["name"] for m in cell.end_to_end} == {"speech_tokens_per_s", "setup_s"}
    assert {m["name"] for m in cell.per_layer} == {
        "device.idle_share.multichip", "model.mfu.multichip", "multichip.step_ms",
        "engine.admit_ms.multichip", "readback.wait_ms.multichip"}
    for name in ("device.idle_share.multichip", "model.mfu.multichip", "multichip.step_ms"):
        assert manifest.reader_path(name).name == name + ".py"
    for name in ("engine.admit_ms", "readback.wait_ms"):
        assert manifest.reader_path(name + ".multichip").name == name + ".py"


def test_tiny_run_times_the_tick():
    c = tiny_cell()
    rec = multichip.run(c, 11, 2.0, False, CPU, time.perf_counter())
    ms = manifest.reader("multichip.step_ms")(rec)
    assert ms is not None and 0 < ms < 1e3 * rec.window_s


def test_tiny_run_has_the_result_shape_and_checks_every_replica():
    c = tiny_cell()
    res = runmod.measure(c, 3_000_000_019, 3.0, False, CPU, time.perf_counter())
    assert res["correct"] is True, res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert list(res) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert set(res["metrics"]) == {"speech_tokens_per_s", "setup_s"}
    assert res["device"]["count"] == 4 and set(res["checks"]) == {"token_gap"}


def test_check_sample_draws_from_each_replica():
    done = [{"replica": i % 3, "req": type("R", (), {"prompt": torch.arange(5 + i).numpy()}),
             "tokens": [1] * (i % 7)} for i in range(30)]
    seqs = multichip.check_sample(done, 3, 11, 8, 2)
    assert 8 <= len(seqs) <= 9
    lens = {len(p) for p, _ in seqs}
    for i in range(3):
        assert len(lens & {5 + j for j in range(30) if j % 3 == i}) >= 2
    longest = max(range(30), key=lambda j: 5 + j + j % 7)
    assert 5 + longest in lens


def test_per_card_readers_average_the_cards():
    from benchmark.harness.record import Run
    from benchmark.harness.trace import DeviceTrace, Spans

    tr = DeviceTrace(Spans())
    tr.unprofiled_s = 2.0
    tr.busy_s = 1.0
    tr.notes.update(busy_by_card=[2.0, 0.0, 1.0, 1.0], cards=4, model_flops=4 * 1979e12 * 0.01)
    run = Run(cell="x", config={"weights": "int8"}, traffic={}, sizes={})
    run.trace = tr
    idle = manifest.reader("device.idle_share.multichip")(run)
    mfu = manifest.reader("model.mfu.multichip")(run)
    assert idle == pytest.approx(50.0) and mfu == pytest.approx(0.5)
    run.trace = None
    assert manifest.reader("device.idle_share.multichip")(run) is None
    assert manifest.reader("model.mfu.multichip")(run) is None
