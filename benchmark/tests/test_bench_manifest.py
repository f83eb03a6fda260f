"""The manifest meets the benchmark's contract, and the harness finds a new
cell, configuration, traffic mix and metric by name, with no edit."""

from __future__ import annotations

import json
import re
import shutil
from pathlib import Path

from benchmark.harness import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_manifest_keys_names_and_files():
    m = manifest.load_manifest()
    assert set(m) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert m["paths"] == ["benchmark"] and m["command"][1] == "benchmark/run.py"
    assert 1 <= m["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in m[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    e2e = {x["name"]: x for x in m["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for x in m["end_to_end"] + m["per_layer"]:
        assert UNIT.match(x["unit"]) and x["better"] in ("lower", "higher")
    for x in m["end_to_end"]:
        assert x["source"] in ("host_clock", "device_trace") and 0.01 <= x["bound"] <= 0.25
    cells = {w["name"]: w for w in m["workloads"]}
    for w in m["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        cell = manifest.load_cell(w["name"])
        reported = {x["name"] for x in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2 and cell.per_layer
        manifest.driver(cell.traffic)  # the traffic's driver exists
    for x in m["per_layer"]:
        assert x["moves"] in e2e and x["source"] in ("device_trace", "program_span",
                                                       "program_counter", "host_clock")
        for w in x["workloads"]:  # each cell it lists reports the metric it moves
            assert w in cells
            assert x["moves"] in {y["name"] for y in manifest.load_cell(w).end_to_end}
    for x in m["end_to_end"] + m["per_layer"]:
        manifest.reader(x["name"])  # a reader file for every metric
    for c in m["configs"]:
        f = json.loads((manifest.ROOT / c["file"]).read_text())
        assert f["source"] == c["source"] and f["reduced"] == c["reduced"]


def test_layers_use_one_name_each():
    m = manifest.load_manifest()
    perf = (manifest.ROOT / "PERF.md").read_text()
    for x in m["per_layer"]:
        assert x["layer"] in perf, x["layer"]


def test_new_files_are_found_by_name(tmp_path: Path):
    """A new configuration, traffic mix, metric and cell: files and entries
    only, found with no edit of the harness."""
    root = tmp_path
    shutil.copytree(manifest.BENCH_DIR, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    m = manifest.load_manifest()
    cfg = json.loads((manifest.BENCH_DIR / "configs" / "air-w8a8-int8kv.json").read_text())
    cfg["name"] = "air-w8a8-int4kv"
    cfg["kv_dtype"] = "int4"
    (root / "benchmark" / "configs" / "air-w8a8-int4kv.json").write_text(json.dumps(cfg))
    t = json.loads((manifest.BENCH_DIR / "traffic" / "serve-backlog.json").read_text())
    t["backlog"] = 16  # a thinner backlog would be another file like this
    (root / "benchmark" / "traffic" / "serve-slow.json").write_text(json.dumps(t))
    (root / "benchmark" / "metrics" / "engine.segments.int4.py").write_text(
        "def read(run):\n    return run.data.get('segments')\n")
    m["configs"].append({"name": "air-w8a8-int4kv", "source": cfg["source"],
                         "file": "benchmark/configs/air-w8a8-int4kv.json", "reduced": [],
                         "why": "int4 KV"})
    m["workloads"].append({"name": "serve-w8a8-int4kv-slow", "config": "air-w8a8-int4kv",
                           "traffic": "serve-slow", "chips": 1, "why": "a new cell"})
    m["end_to_end"].append({"name": "request_latency_p50_s", "unit": "s", "better": "lower",
                            "bound": 0.05, "source": "host_clock",
                            "workloads": ["serve-w8a8-int4kv-slow"]})
    (root / "benchmark" / "metrics" / "request_latency_p50_s.py").write_text(
        "def read(run):\n    return 1.5\n")
    m["per_layer"].append({"name": "engine.segments.int4", "unit": "segments",
                           "better": "higher", "source": "program_counter",
                           "layer": "serving engine (host)", "moves": "request_latency_p50_s",
                           "workloads": ["serve-w8a8-int4kv-slow"]})
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    cell = manifest.load_cell("serve-w8a8-int4kv-slow", root=root)
    assert cell.config["kv_dtype"] == "int4" and cell.traffic["backlog"] == 16
    assert {x["name"] for x in cell.end_to_end} == {"request_latency_p50_s", "setup_s"}
    assert [x["name"] for x in cell.per_layer] == ["engine.segments.int4"]
    assert manifest.driver(cell.traffic).__name__ == "benchmark.drivers.engine"
    # a metric of a layer already read elsewhere needs no file: its name
    # without the last dotted part finds the reader
    assert manifest.reader_path("device.idle_share.int4", root).name == "device.idle_share.py"

    class R:
        data = {"segments": 7}
        setup_s = 3.0

    got = manifest.read_metrics(cell.per_layer + cell.end_to_end, R(), root=root)
    assert got == {"engine.segments.int4": {"value": 7.0, "unit": "segments"},
                   "request_latency_p50_s": {"value": 1.5, "unit": "s"},
                   "setup_s": {"value": 3.0, "unit": "s"}}
    # the accepted cells are unchanged by the addition
    assert {x["name"] for x in manifest.load_cell("serve-w8a8-backlog", root=root).end_to_end} \
        == {"speech_tokens_per_s", "setup_s"}
