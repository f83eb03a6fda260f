"""Where the time goes on the GPU: prefill and decode of the Air backbone.

    python -m neutts_tpu_torch.tools.profile_decode

For each mode — W8A8 weights with an int8 KV cache, and bf16 weights with a
bf16 cache — builds Air with seeded random weights, prefills 8 ragged
prompts in a 384-token bucket (the bucket chip_smoke.py's prompts take),
then profiles one prefill and a window of decode steps with torch.profiler.
Prints, per window: wall ms, the device's busy and idle share (the union of
kernel intervals over the window), and the kernels with the most device
time, then the whole report as one JSON line. Needs one GPU.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import torch

from neutts_tpu_torch import config
from neutts_tpu_torch.models import backbone as bb
from neutts_tpu_torch.ops import _build
from neutts_tpu_torch.runtime import decode as dec

B, BUCKET, WARM, STEPS = 8, 384, 5, 10


def _busy_ms(events) -> float:
    """Length of the union of the device kernel intervals (ms)."""
    iv = sorted((e.time_range.start, e.time_range.end) for e in events
                if e.device_type == torch.autograd.DeviceType.CUDA)
    total, cur_s, cur_e = 0, None, None
    for s, e in iv:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e3  # us -> ms


def _window(fn, label):
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy = _busy_ms(prof.events())
    rows = []
    for a in prof.key_averages():
        dev_us = getattr(a, "self_device_time_total", None)
        if dev_us is None:
            dev_us = a.self_cuda_time_total
        if dev_us > 0:
            rows.append({"name": a.key[:80], "device_ms": dev_us / 1e3, "calls": a.count})
    rows.sort(key=lambda r: -r["device_ms"])
    out = {"window": label, "wall_ms": wall, "device_busy_ms": busy,
           "idle_share": 1.0 - busy / wall, "top": rows[:12]}
    print(f"{label}: wall {wall:.2f} ms, device busy {busy:.2f} ms "
          f"(idle {100 * out['idle_share']:.1f}%)")
    for r in rows[:12]:
        print(f"    {r['device_ms']:9.3f} ms  {r['calls']:6d}x  {r['name']}")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_decode: needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(f"gpu: {smi}")
    _build.build_all()
    report = {"gpu": smi, "batch": B, "bucket": BUCKET, "modes": {}}
    g = torch.Generator(device="cpu").manual_seed(0)
    lens = [BUCKET - int(x) for x in torch.randint(0, 64, (B,), generator=g)]
    prompts = [torch.randint(0, 151_000, (n,), generator=g).tolist() for n in lens]
    for mode in ("w8a8_int8kv", "bf16"):
        cfg = config.AIR.scaled(kv_dtype="int8" if mode != "bf16" else "bfloat16")
        params = bb.init_params(cfg, seed=0, device=dev)
        if mode != "bf16":
            params = bb.quantize_params(params)
        toks, plens = dec.pad_prompts(prompts, pad_id=0, bucket=BUCKET, device=dev)
        pad = (BUCKET - plens).to(torch.int32)
        state = {}

        def do_prefill():
            cache = bb.KVCache.create(cfg, B, max_len=BUCKET + 256, device=dev)
            state["logits"], state["cache"] = bb.prefill(cfg, params, toks, plens, cache)

        def steps(n, start):
            tok = torch.full((B,), 200_000, dtype=torch.int32, device=dev)
            for s in range(n):
                logits, _ = bb.decode_step(cfg, params, tok, state["cache"], start + s, pad,
                                           trim_logits=False)
                tok = torch.argmax(logits, dim=-1).to(torch.int32)

        with torch.inference_mode():
            do_prefill()  # warm-up (allocator, libraries)
            res = {"prefill": _window(do_prefill, f"{mode} prefill [{B}x{BUCKET}]")}
            steps(WARM, BUCKET)
            res["decode"] = _window(lambda: steps(STEPS, BUCKET + WARM),
                                    f"{mode} decode, {STEPS} steps")
        res["decode"]["ms_per_step"] = res["decode"]["wall_ms"] / STEPS
        report["modes"][mode] = res
        del params, state
        torch.cuda.empty_cache()
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
