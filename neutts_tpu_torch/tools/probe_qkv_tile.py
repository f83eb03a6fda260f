"""Device time of the fused W8A8 QKV (#7) by GEMM tile.

    python -m neutts_tpu_torch.tools.probe_qkv_tile [--parent <dir>/csrc/w8a8.cu]

The QKV GEMM takes 64 token rows with 3 k steps in flight below
NEUTTS_QKV_WIDE_M rows and 128 rows with 2 from there (128 columns each).
This builds `csrc/w8a8.cu` three times, as it ships ("by_m") and with the
64-row tile ("bm64", -DNEUTTS_QKV_WIDE_M=INT_MAX) or the 128-row tile
("bm128", -DNEUTTS_QKV_WIDE_M=0) at every M, and calls each library's
`neutts_fused_qkv` on the same bf16 inputs at the Air width (D 896, N
1152) at M 3072 and 4096 (the pipeline's 8 x 384 and 8 x 512), 8192,
16384 and 32768 (admission groups of 16, 32 and 64 x 512). With
--parent it also builds another checkout's w8a8.cu, whose QKV takes the
weight row-major, and times it beside them. Per variant: max error against
`fused_qkv_plain` (limit 2e-2 of the output's range) and device ms, warm
L2 (calls back to back) and L2 flushed (each call alone after a 256 MB
write), both from events around calls queued behind a spin kernel;
variants run in turns (a b c c b a). Then a torch.profiler trace of a few
warm calls of each splits its device time between the row pass and the
GEMM. Prints one JSON line. Needs one GPU and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

from neutts_tpu_torch import config
from neutts_tpu_torch.models import backbone as bb
from neutts_tpu_torch.ops import _build
from neutts_tpu_torch.ops import mlp as mlp_ops

ITERS, SPIN = 20, 200_000_000  # cycles of torch.cuda._sleep: ~0.1 s on an H100


def _build_variants(variants) -> dict:
    """tag -> loaded neutts_fused_qkv, one nvcc per variant, all at once."""
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for tag, src, defines in variants:
        out = _build.BUILD_DIR / f"probe-qkv-{tag}.so"
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, *defines, "-I", str(Path(src).parent),
               "-o", str(out), str(src)]
        procs.append((tag, out, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                 stderr=subprocess.STDOUT, text=True)))
    fns = {}
    for tag, out, p in procs:
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {tag}:\n{log}")
        fn = ctypes.CDLL(str(out)).neutts_fused_qkv
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_float,
                                                                    ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[tag] = fn
    return fns


def _split(tags, call, n=10) -> dict:
    """tag -> {kernel: device ms per call} over n warm calls, from a
    torch.profiler trace (row pass vs GEMM)."""
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for tag in tags:
        call(tag)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                call(tag)
            torch.cuda.synchronize()
        out[tag] = {("row_pass" if "norm_quant" in e.key else "gemm"):
                    e.device_time_total / n / 1e3
                    for e in prof.key_averages() if e.device_time_total > 0}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="another checkout's csrc/w8a8.cu (row-major QKV weight)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_qkv_tile: needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    src = _build.CSRC / "w8a8.cu"
    variants = [("by_m", src, []), ("bm64", src, [f"-DNEUTTS_QKV_WIDE_M={2**31 - 1}"]),
                ("bm128", src, ["-DNEUTTS_QKV_WIDE_M=0"])]
    if args.parent:
        variants.append(("parent", Path(args.parent).resolve(), []))
    fns = _build_variants(variants)

    cfg = config.AIR
    D, N = cfg.hidden_size, cfg.q_dim + 2 * cfg.kv_dim
    g = torch.Generator(device=dev).manual_seed(0)
    nw = (1.0 + 0.1 * torch.randn(D, generator=g, device=dev)).float()
    w = bb.quantize_weight(torch.randn(D, N, generator=g, device=dev) * D**-0.5)
    w_k = bb.k_major(w["q"])
    bias = torch.randn(N, generator=g, device=dev) * 0.05
    l2_flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    rows = []
    for M in (3072, 4096, 8192, 16384, 32768):
        x = (torch.randn(M, D, generator=g, device=dev) * 0.5).bfloat16()
        xq = torch.empty(M, D, dtype=torch.int8, device=dev)
        xs = torch.empty(M, dtype=torch.float32, device=dev)
        out = torch.empty(M, N, dtype=torch.bfloat16, device=dev)
        want = mlp_ops.fused_qkv_plain(x, nw, w_k, w["s"], bias).float()

        def call(tag):
            wt = w["q"] if tag == "parent" else w_k
            rc = fns[tag](x.data_ptr(), nw.data_ptr(), wt.data_ptr(), w["s"].data_ptr(),
                          bias.data_ptr(), xq.data_ptr(), xs.data_ptr(), out.data_ptr(), M, D,
                          N, _build.DTYPE_CODE[torch.bfloat16], 1e-6, stream)
            _build.check(rc, f"fused_qkv {tag}")

        def device_ms(tag):
            for _ in range(3):
                call(tag)
            ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                  for _ in range(ITERS + 1)]
            torch.cuda.synchronize()
            torch.cuda._sleep(SPIN)
            ev[-1][0].record()
            for _ in range(ITERS):
                call(tag)
            ev[-1][1].record()
            for i in range(ITERS):
                l2_flush.zero_()
                ev[i][0].record()
                call(tag)
                ev[i][1].record()
            torch.cuda.synchronize()
            return (ev[-1][0].elapsed_time(ev[-1][1]) / ITERS,
                    sum(s.elapsed_time(e) for s, e in ev[:ITERS]) / ITERS)

        tags = [v[0] for v in variants]
        order = tags + tags[::-1]
        times = {t: [] for t in tags}
        err = {}
        for tag in order:
            call(tag)
            torch.cuda.synchronize()
            err[tag] = float((out.float() - want).abs().max())
            times[tag].append(device_ms(tag))
        tol = 2e-2 * float(want.abs().max())
        for tag in tags:
            row = {"M": M, "variant": tag, "max_abs_err": err[tag], "tol": tol,
                   "device_warm_ms": [t[0] for t in times[tag]],
                   "device_ms": [t[1] for t in times[tag]]}
            rows.append(row)
            print(f"M {M} {tag}: err {err[tag]:.3e} (tol {tol:.3e}) | device ms warm "
                  f"{row['device_warm_ms']} | L2 flushed {row['device_ms']}")
            if err[tag] > tol:
                raise RuntimeError(f"fused_qkv {tag} at M {M} disagrees with its plain version")
        split = _split(tags, call)
        for row in rows[-len(tags):]:
            row["split_ms"] = split[row["variant"]]
        print(f"M {M} device ms per call by kernel (warm, profiled): {split}")
        del x, xq, xs, out, want
        torch.cuda.empty_cache()
    print(smi)
    print(json.dumps({"gpu": smi, "D": D, "N": N, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
