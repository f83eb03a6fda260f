"""Host and device time of decode's `torch._int_mm` by weight layout.

    python -m neutts_tpu_torch.tools.probe_int_mm

The W8A8 decode projections (`backbone._mm`) call `torch._int_mm` at M =
32 (the pipeline's batch 8, padded) and M = 128 (128 serving slots). The
MLP's weights are stored K-major for the fused MLP kernel; this probe
times the same product on a row-major [K, N] weight and on its K-major
view, at the Air MLP's gate/up [896, 4864] and down [4864, 896] shapes:
- host µs per call: the calls enqueued behind a spin kernel that holds the
  stream, so the host never waits on the device (what a host-bound decode
  loop pays per call);
- device µs per call: events around the same calls behind the spin kernel.
Layouts alternate (row, K-major, K-major, row) and each pair is reported.
Prints one JSON line. Needs one GPU.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import torch

from neutts_tpu_torch.models import backbone as bb

CALLS, SPIN = 400, 400_000_000  # cycles of torch.cuda._sleep: ~0.2 s on an H100


def _time(a, w):
    """(host µs, device µs) per call of torch._int_mm(a, w)."""
    for _ in range(10):
        torch._int_mm(a, w)
    torch.cuda.synchronize()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN)
    s.record()
    t0 = time.perf_counter()
    for _ in range(CALLS):
        torch._int_mm(a, w)
    host = (time.perf_counter() - t0) / CALLS * 1e6
    e.record()
    torch.cuda.synchronize()
    return host, s.elapsed_time(e) / CALLS * 1e3


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_int_mm: needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    g = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for K, N in ((896, 4864), (4864, 896)):
        w_row = torch.randint(-127, 128, (K, N), generator=g, device=dev, dtype=torch.int8)
        w_k = bb.k_major(w_row)
        for M in (32, 128):
            a = torch.randint(-127, 128, (M, K), generator=g, device=dev, dtype=torch.int8)
            assert torch.equal(torch._int_mm(a, w_row), torch._int_mm(a, w_k))
            t = {"row": [], "k_major": []}
            for name in ("row", "k_major", "k_major", "row"):
                t[name].append(_time(a, w_row if name == "row" else w_k))
            r = {"M": M, "K": K, "N": N}
            for name, v in t.items():
                r[f"{name}_host_us"] = [round(h, 2) for h, _ in v]
                r[f"{name}_device_us"] = [round(d, 2) for _, d in v]
            rows.append(r)
            print(f"M {M} K {K} N {N}: host us row {r['row_host_us']} k-major "
                  f"{r['k_major_host_us']} | device us row {r['row_device_us']} k-major "
                  f"{r['k_major_device_us']}")
    print(json.dumps({"gpu": smi, "calls": CALLS, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
