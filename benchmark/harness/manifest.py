"""Finds what a cell needs by name: its entry in `BENCHMARK.json`, its
configuration file, its traffic file, its driver and its metric readers.

Nothing here knows a particular cell. A new cell is an entry of
`workloads`; a new configuration a file under `configs/`; a new traffic mix a
file under `traffic/` whose `driver` names a module of `drivers/`; a new
metric an entry of `end_to_end` or `per_layer`, read by `metrics/<name>.py`
with a function `read(run)`. Where that file is absent the name loses its
last dotted part until a file matches: `device.idle_share.backlog` and a
later `device.idle_share.admit` both read `metrics/device.idle_share.py`.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List, Tuple

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


@dataclass
class Cell:
    """One workload of the manifest with everything it names, loaded."""

    name: str
    chips: int
    config: dict  # the configuration file's object
    traffic: dict  # the traffic file's object
    end_to_end: List[dict]  # the manifest's end-to-end metrics this cell reports
    per_layer: List[dict]  # the manifest's per-layer metrics this cell reports


def load_manifest(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _reports(metric: dict, cell: str, e2e_names: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    # a metric without a list: every cell that reports the metric it moves
    return metric.get("moves") is None or metric["moves"] in e2e_names


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The workload `name` of the manifest at `root`, with its files read."""
    manifest = load_manifest(root)
    entries = {w["name"]: w for w in manifest["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = entries[name]
    configs = {c["name"]: c for c in manifest["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    traffic = load_traffic(w["traffic"], root)
    e2e = [m for m in manifest["end_to_end"] if _reports(m, name, set())]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in manifest["per_layer"] if _reports(m, name, names)]
    return Cell(name=name, chips=int(w["chips"]), config=config, traffic=traffic,
                end_to_end=e2e, per_layer=per_layer)


def traffic_path(mix: str, root: Path = ROOT) -> Path:
    for ext in (".json", ".jsonl", ".toml", ".txt", ".csv"):
        p = root / "benchmark" / "traffic" / f"{mix}{ext}"
        if p.exists():
            return p
    raise FileNotFoundError(f"no traffic file for mix {mix!r} under benchmark/traffic/")


def load_traffic(mix: str, root: Path = ROOT) -> dict:
    p = traffic_path(mix, root)
    if p.suffix != ".json":
        raise ValueError(f"traffic {p.name}: this generator reads JSON parameter files")
    t = json.loads(p.read_text())
    t.setdefault("name", mix)
    return t


def driver(traffic: dict):
    """The driver module a traffic file names (`drivers/<driver>.py`)."""
    return importlib.import_module(f"benchmark.drivers.{traffic['driver']}")


_readers: Dict[Tuple[str, str], Callable] = {}


def reader_path(metric: str, root: Path = ROOT) -> Path:
    """`metrics/<metric>.py`, or the file of the longest dotted prefix of
    the name that has one."""
    parts = metric.split(".")
    for n in range(len(parts), 0, -1):
        path = root / "benchmark" / "metrics" / (".".join(parts[:n]) + ".py")
        if path.exists():
            return path
    raise FileNotFoundError(f"no reader under benchmark/metrics/ for metric {metric!r}")


def reader(metric: str, root: Path = ROOT) -> Callable:
    """`read(run)` of the metric's file: returns a number, or None when the
    run holds nothing for it to read."""
    key = (str(root), metric)
    if key not in _readers:
        path = reader_path(metric, root)
        spec = importlib.util.spec_from_file_location(f"benchmark.metrics._{len(_readers)}",
                                                      path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _readers[key] = mod.read
    return _readers[key]


def read_metrics(metrics: List[dict], run, root: Path = ROOT) -> Dict[str, dict]:
    """{name: {"value", "unit"}} of every metric whose reader found a value."""
    out = {}
    for m in metrics:
        v = reader(m["name"], root)(run)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out
