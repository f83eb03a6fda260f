"""Readings of the numbers that decide `correct`, for setting their limits:
the program's on many seeds (the lower readings) and the control's (the
upper ones), in one process, with a short window at the cell's own load.

    python3 benchmark/readings.py --workload <name> --seeds 11,12,... \\
        [--control-seeds 11,12,13] [--seconds 20] [--device cuda]

For each seed: the cell's set-up and window (not traced), the check as a run
makes it, and on the control seeds the same served tokens and audio read by
the control: the reference in the next precision below the configuration's
(the configuration's `control`: int4 for int8, fp8 for bf16; the codec with
TF32 on). Prints one JSON line per seed, then the largest program reading
and the smallest control reading of each number. The benchmark's own runs
never run the control.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def read_seed(cell, seed: int, seconds: float, device, control: bool) -> dict:
    from benchmark.harness import manifest

    drv = manifest.driver(cell.traffic)
    t0 = time.perf_counter()
    rec = drv.run(cell, seed, seconds, False, device, t0)
    out = {"seed": seed, "setup_s": rec.setup_s, "attempted": rec.attempted,
           "failed": rec.failed}
    out.update(drv.compare(rec, seed, device,
                           control=cell.config["control"] if control else None))
    return out


def summarise(rows) -> dict:
    keys = sorted({k for r in rows for k in r if k.endswith("_gap") and not
                   k.startswith("control_")})
    out = {}
    for k in keys:
        prog = [r[k] for r in rows if k in r]
        ctl = [r["control_" + k] for r in rows if "control_" + k in r]
        out[k] = {"lower": max(prog), "seeds": len(prog),
                  "upper": min(ctl) if ctl else None, "control_seeds": len(ctl)}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark.harness import manifest

    cell = manifest.load_cell(args.workload)
    device = torch.device(args.device, 0) if args.device == "cuda" else torch.device("cpu")
    if device.type == "cuda" and not torch.cuda.is_available():
        print("readings.py: no CUDA device", file=sys.stderr)
        return 2
    ctl = {int(s) for s in args.control_seeds.split(",") if s}
    rows = []
    for s in [int(x) for x in args.seeds.split(",")]:
        r = read_seed(cell, s, args.seconds, device, s in ctl)
        rows.append(r)
        print(json.dumps(r), flush=True)
        if device.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
    print(json.dumps({"workload": args.workload, "readings": summarise(rows)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
