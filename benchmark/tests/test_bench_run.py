"""A run end to end on the CPU at tiny sizes (the card's look skipped), and
the ways a run must end without a result."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import time
import warnings
from pathlib import Path

import pytest
import torch

from benchmark import run as runmod
from benchmark.harness.manifest import BENCH_DIR, ROOT
from benchmark.tests import tiny

CPU = torch.device("cpu")
ENV = {"PATH": "/usr/bin:/bin", "USE_FLAX": "0"}


@pytest.fixture(autouse=True)
def _quiet():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the rule-based G2P says it is not espeak
        yield


@pytest.mark.parametrize("cell,config,mix", [
    ("serve-w8a8-backlog", "air-w8a8-int8kv", "serve-backlog"),
    ("stream-bf16", "air-bf16", "stream-closed"),
])
def test_tiny_run_is_correct_and_reports(cell, config, mix):
    from benchmark.harness import manifest

    c = tiny.cell(cell, config, mix)
    real = manifest.load_cell(cell)
    c.end_to_end, c.per_layer = real.end_to_end, real.per_layer
    res = runmod.measure(c, 3_000_000_019, 4.0, False, CPU, time.perf_counter())
    assert res["correct"] is True, res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert set(res["metrics"]) == {m["name"] for m in c.end_to_end}
    assert all(v["value"] > 0 for v in res["metrics"].values())
    assert list(res)[-1] == "checks"
    assert set(res["checks"]) == set(c.config["limits"])


def test_without_a_card_no_result():
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "serve-w8a8-backlog", "--seed", "5", "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300, env=ENV)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_without_the_program_no_result(tmp_path: Path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "serve-w8a8-backlog", "--seed", "5", "--seconds", "1", "--trace", "0"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=300, env=ENV)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_result_line_is_json_of_the_contract_keys():
    c = tiny.cell("serve-w8a8-backlog", "air-w8a8-int8kv", "serve-backlog")
    res = runmod.measure(c, 7, 2.0, False, CPU, time.perf_counter())
    line = json.loads(json.dumps(res))
    assert set(line) == {"correct", "attempted", "failed", "metrics", "device", "checks"}
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
