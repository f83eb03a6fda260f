"""Device time of the segment reconcile (#3), this checkout against another.

    python -m neutts_tpu_torch.tools.probe_reconcile [--parent <dir>/csrc/slot_copy.cu]

At the W8A8 Air serving shape (L 24, B 128 slots, S 32 staging steps, K*D
128; T 2304 for int8, 2560 for int4), about half the rows active with
bases on the 16-token grid, calls `neutts_reconcile_segment` (int8) and
`neutts_reconcile_segment4` (int4) of this checkout's `csrc/slot_copy.cu`
("change") and, with --parent, of another checkout's (built beside it;
the C interface is the same). Per library and mode: whether the cache
equals the plain version's byte for byte, and device ms from events
around calls queued behind a spin kernel: warm L2 (calls back to back),
L2 flushed by a write (each call alone after a 256 MB memset, as
chip_smoke.py times every kernel: L2 is then full of dirty lines, and
every line the call brings in or writes first evicts one to HBM) and L2
flushed by a read (each call alone after a 256 MB read: L2 full of clean
lines, nothing to write back).
Libraries run in turns (a b b a), each call on the same buffers (a
reconcile rewrites the same bytes). The same three times with no row
active give each library's floor: the launch and one read of `active`.
Prints one JSON line. Needs one GPU and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

from neutts_tpu_torch.ops import _build
from neutts_tpu_torch.ops import attention as attn

ITERS, SPIN = 50, 200_000_000  # cycles of torch.cuda._sleep: ~0.1 s on an H100
L, B, S, KD = 24, 128, 32, 128


def _bind(lib: ctypes.CDLL, name: str):
    fn = getattr(lib, name)
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="another checkout's csrc/slot_copy.cu")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_reconcile: needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    libs = {"change": _build.library("slot_copy.cu")}
    if args.parent:
        src = Path(args.parent).resolve()
        out = _build.BUILD_DIR / "probe-slot_copy-parent.so"
        subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(src.parent), "-o",
                        str(out), str(src)], check=True, capture_output=True, text=True)
        libs["parent"] = ctypes.CDLL(str(out))
    l2_flush = torch.zeros(256 << 20, dtype=torch.uint8, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    g = torch.Generator(device=dev).manual_seed(0)

    rows = []
    for mode, T, entry, plain in (
            ("int8", 2304, "neutts_reconcile_segment", attn.reconcile_segment_plain),
            ("int4", 2560, "neutts_reconcile_segment4", attn.reconcile_segment4_plain)):
        Tb = T // 2 if mode == "int4" else T
        cache = [torch.randint(-119, 120, (L, B, Tb, KD), generator=g, device=dev,
                               dtype=torch.int8) for _ in range(2)]
        cache += [torch.rand((L, B, T), generator=g, device=dev) for _ in range(2)]
        lo = 7 if mode == "int4" else 127
        stag = [torch.randint(-lo, lo + 1, (L, B, S, KD), generator=g, device=dev,
                              dtype=torch.int8) for _ in range(2)]
        stag += [torch.rand((L, B, attn.SEG_PAD), generator=g, device=dev) for _ in range(2)]
        base = torch.randint(0, (T - S) // 16 + 1, (B,), generator=g, device=dev,
                             dtype=torch.int32) * 16
        active = torch.rand(B, generator=g, device=dev) < 0.5
        want = plain(*(t.clone() for t in cache), *stag, base, active)
        n_act = int(active.sum())
        value_bytes = 3 * KD if mode == "int4" else 4 * KD  # staged read + cache write, K and V
        nbytes = n_act * L * S * (value_bytes + 16) + 5 * B
        fns = {tag: _bind(lib, entry) for tag, lib in libs.items()}

        none = torch.zeros_like(active)

        def call(tag, bufs, act=active):
            rc = fns[tag](*(t.data_ptr() for t in stag), base.data_ptr(), act.data_ptr(),
                          *(t.data_ptr() for t in bufs), L, B, T, S, KD, attn.SEG_PAD, stream)
            _build.check(rc, f"{entry} {tag}")

        def device_ms(tag, bufs, act=active):
            """(warm, write-flushed, read-flushed) device ms per call."""
            for _ in range(3):
                call(tag, bufs, act)
            ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                  for _ in range(2 * ITERS + 1)]
            torch.cuda.synchronize()
            torch.cuda._sleep(SPIN)
            ev[-1][0].record()
            for _ in range(ITERS):
                call(tag, bufs, act)
            ev[-1][1].record()
            for i in range(2 * ITERS):
                if i < ITERS:
                    l2_flush.zero_()
                else:
                    l2_flush.view(torch.float32).sum()
                ev[i][0].record()
                call(tag, bufs, act)
                ev[i][1].record()
            torch.cuda.synchronize()
            ms = [s.elapsed_time(e) for s, e in ev[:-1]]
            return (ev[-1][0].elapsed_time(ev[-1][1]) / ITERS, sum(ms[:ITERS]) / ITERS,
                    sum(ms[ITERS:]) / ITERS)

        tags = list(libs)
        times = {t: [] for t in tags}
        floor = {t: [] for t in tags}
        exact = {}
        for tag in tags + tags[::-1]:
            bufs = [t.clone() for t in cache]
            call(tag, bufs)
            torch.cuda.synchronize()
            exact[tag] = all(torch.equal(a, b) for a, b in zip(bufs, want))
            times[tag].append(device_ms(tag, bufs))
            floor[tag].append(device_ms(tag, bufs, none))
        bound_ms = nbytes / 3.35e12 * 1e3
        for tag in tags:
            row = {"mode": mode, "library": tag, "exact": exact[tag], "active_rows": n_act,
                   "bytes": nbytes, "bound_ms": bound_ms,
                   "device_warm_ms": [t[0] for t in times[tag]],
                   "device_ms": [t[1] for t in times[tag]],
                   "device_read_flushed_ms": [t[2] for t in times[tag]],
                   "no_active_row_ms": floor[tag]}
            rows.append(row)
            print(f"{mode} {tag}: exact {exact[tag]} | {n_act} active rows | device ms warm "
                  f"{row['device_warm_ms']} | L2 flushed by a write {row['device_ms']}, by a "
                  f"read {row['device_read_flushed_ms']} | bound {bound_ms:.4f} "
                  f"({nbytes} bytes) | no row active (warm, write, read) {floor[tag]}")
        if not all(exact.values()):
            raise RuntimeError(f"{entry}: a library disagrees with the plain version")
        del cache, stag, want
        torch.cuda.empty_cache()
    print(smi)
    print(json.dumps({"gpu": smi, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
