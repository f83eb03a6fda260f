"""Runs one cell of the benchmark once, on the machine it is started on.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cell is an entry of `workloads` in
`BENCHMARK.json`; its configuration, traffic mix, driver and metric readers
are found by name under `benchmark/`. Set-up makes the weights from the seed
on the card, builds the port (`neutts_tpu_torch`), warms every shape the
cell's traffic uses, and runs the traffic until the window opens; the window
lasts `--seconds`; then the program is freed and the plain reference checks
what the window served.

The last line of standard output is one JSON object: `correct`, `attempted`,
`failed`, `metrics` (the cell's end-to-end metrics, or with `--trace 1` its
per-layer metrics), `device` (and `breakdown` when traced), then `checks`,
each compared number beside its limit. Those numbers are also the last lines
of standard error. Without a CUDA device, or with fewer than the cell needs,
or with JAX or the JAX package loaded at the end, it exits non-zero and
prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / ".bench_cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "neutts_tpu")


def _environment() -> None:
    """Build and kernel caches inside the checkout, at fixed paths; libraries
    that could load JAX by themselves told not to; few host threads."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda_jit")):
        os.environ[var] = str(CACHE / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "2"


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip()
        return out.splitlines()[0] if out else "nvidia-smi: no output"
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _environment()
    sys.path.insert(0, str(ROOT))

    import torch

    from benchmark.harness import manifest

    cell = manifest.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"run.py: {args.workload} needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    try:
        import neutts_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"run.py: the program is not in this checkout ({e})", file=sys.stderr)
        return 3
    result = measure(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0),
                     T_START)
    bad = forbidden_modules()
    if bad:
        print(f"run.py: loaded in this process: {', '.join(bad)}", file=sys.stderr)
        return 4
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


def measure(cell, seed: int, seconds: float, trace: bool, device, t_start: float) -> dict:
    """One run of `cell` on `device`: set-up, the window, the check. Returns
    the result object (the chip's presence is the caller's to check)."""
    import torch

    from benchmark.harness import check, manifest

    drv = manifest.driver(cell.traffic)
    rec = drv.run(cell, seed, seconds, trace, device, t_start)
    on_card = device.type == "cuda"
    # the card's name and power limit, beside every roofline and mfu share
    print(f"card: {card_line() if on_card else 'cpu'}", file=sys.stderr)
    t0 = time.perf_counter()
    ok, checks = check.judge(drv.compare(rec, seed, device), cell.config["limits"])
    ok = ok and rec.failed == 0
    metrics = cell.per_layer if trace else cell.end_to_end
    result = {
        "correct": bool(ok), "attempted": rec.attempted, "failed": rec.failed,
        "metrics": manifest.read_metrics(metrics, rec),
        "device": {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
                   "count": cell.chips, "memory_peak_bytes": rec.memory_peak_bytes},
    }
    if rec.trace is not None:
        result["device"]["busy_s"] = rec.trace.busy_s
        result["device"]["window_s"] = rec.trace.window_s
        result["breakdown"] = rec.trace.breakdown
        print(f"trace: {rec.trace.window_s:.3f} s sub-window ({rec.trace.unprofiled_s:.3f} s "
              f"unprofiled), busy {rec.trace.busy_s:.3f} s "
              f"({rec.trace.inside_share!r} of it between start and stop), "
              f"{len(rec.trace.kernels)} device events, reduced in {rec.trace.parse_s:.1f} s; "
              f"profiled over unprofiled span medians {json.dumps(rec.trace.stretch())}",
              file=sys.stderr)
        print("trace notes: " + json.dumps(rec.trace.notes, default=float), file=sys.stderr)
    result["checks"] = checks
    side = {"setup_s": rec.setup_s, "window_s": rec.window_s,
            "check_s": time.perf_counter() - t0}
    for name, v in sorted(rec.spans.seconds.items()):
        q = sorted(v)
        side[f"span {name}"] = {"n": len(q), "total_s": sum(q), "min_s": q[0],
                                "median_s": q[len(q) // 2], "max_s": q[-1]}
    side.update((k, v) for k, v in rec.data.items() if not k.startswith("check_"))
    print("run: " + json.dumps(side, default=float)[:6000], file=sys.stderr)
    for name, v in checks.items():
        print(f"check {name}: {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    return result


if __name__ == "__main__":
    sys.exit(main())
