"""Where the time goes in the serving Engine on the GPU.

    python -m neutts_tpu_torch.tools.profile_serving

W8A8 Air with an int8 KV cache, 128 slots and 32-step segments (the
configuration of chip_smoke.py's serving phase): fills every slot with
512-token speech prompts and a budget no segment here exhausts, runs one
warm-up tick, six ticks timed without the profiler (wall ms, split into the
host's dispatch and the wait for the readback) and three more with host
timers (perf_counter, no synchronisation) around the staged decode
attention wrapper, the projection dispatch `backbone._mm` and the
`int8_matmul` inside it (calls and host µs per call in a segment). Then it
profiles with torch.profiler (1) one engine tick, which is one staged decode
segment and its readback, and (2) one admission group of 64 prompts
(prefill_slots, Lp 512). Prints, per window: wall ms, the device's busy and
idle share, and the kernels with the most device time, then the whole
report as one JSON line. The profiler slows the host, so the tick also
reports its idle share against the median wall time of the unprofiled ticks
of the same process. Needs one GPU.

The script uses only entry points that the port has had since its serving
slice, so it also runs against an older checkout of the package:
`cd <checkout> && PYTHONPATH=. python <this file>` imports the checkout's
package.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from collections import defaultdict

import torch

from neutts_tpu_torch import config
from neutts_tpu_torch.models import backbone as bb
from neutts_tpu_torch.ops import _build
from neutts_tpu_torch.ops import attention as attn_ops
from neutts_tpu_torch.ops import mlp as mlp_ops
from neutts_tpu_torch.runtime import batching
from neutts_tpu_torch.serving import Engine
from neutts_tpu_torch.tools.profile_decode import _window

N_SLOTS, SEGMENT, LP, GROUP, UNPROFILED, HOST_TIMED = 128, 32, 512, 64, 6, 3
# (module, function) pairs whose host time per call the timed ticks read
_TIMED = ((attn_ops, "decode_attention_staged"), (bb, "_mm"), (mlp_ops, "int8_matmul"))


def _timed_tick(eng) -> dict:
    """One engine tick with host timers around the functions of `_TIMED`:
    wall ms, and per function its calls and host ms in the tick."""
    acc = defaultdict(lambda: [0, 0.0])
    orig = {}

    def timer(name, fn):
        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                a = acc[name]
                a[0] += 1
                a[1] += time.perf_counter() - t0
        return timed

    for mod, name in _TIMED:
        orig[name] = getattr(mod, name)
        setattr(mod, name, timer(name, orig[name]))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    finally:
        for mod, name in _TIMED:
            setattr(mod, name, orig[name])
    return {"wall_ms": wall, **{name: {"calls": acc[name][0], "host_ms": acc[name][1] * 1e3}
                                for _, name in _TIMED}}


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_serving: needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(f"gpu: {smi}")
    _build.build_all()
    cfg = config.AIR.scaled(kv_dtype="int8")
    lay = cfg.layout
    params = bb.quantize_params(bb.init_params(cfg, seed=0, device=dev))
    scfg = config.SamplingConfig(min_new_tokens=1000).constrained_to(lay)
    eng = Engine(cfg, params, eos_id=lay.speech_gen_end, n_slots=N_SLOTS, sampling=scfg,
                 segment_steps=SEGMENT, device=dev)
    del params
    g = torch.Generator(device="cpu").manual_seed(0)
    prompts = (lay.speech_base + torch.randint(0, lay.codebook_size, (N_SLOTS, LP),
                                               generator=g)).tolist()
    for p in prompts:
        eng.submit(p, max_new=1000)
    eng.step()  # admits every slot and runs one segment (warm-up)
    walls, dispatch = [], []
    for _ in range(UNPROFILED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pending = eng.step_dispatch()
        t1 = time.perf_counter()
        eng.step_collect(pending)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        dispatch.append((t1 - t0) * 1e3)
    timed = [_timed_tick(eng) for _ in range(HOST_TIMED)]
    tick = _window(eng.step, f"engine tick: one {SEGMENT}-step segment, {N_SLOTS} active slots")
    tick["ms_per_step"] = tick["wall_ms"] / SEGMENT
    tick["unprofiled_wall_ms"] = walls
    tick["unprofiled_dispatch_ms"] = dispatch
    tick["host_timed"] = timed
    tick["idle_share_unprofiled"] = 1.0 - tick["device_busy_ms"] / statistics.median(walls)
    print(f"unprofiled ticks: {', '.join(f'{w:.1f}' for w in walls)} ms; idle against their "
          f"median {100 * tick['idle_share_unprofiled']:.1f}%; host dispatch "
          f"{', '.join(f'{d:.1f}' for d in dispatch)} ms")
    for t in timed:
        print(f"host-timed tick: wall {t['wall_ms']:.1f} ms; " + "; ".join(
            f"{name} {t[name]['calls']} calls {t[name]['host_ms']:.1f} ms "
            f"({1e3 * t[name]['host_ms'] / max(t[name]['calls'], 1):.1f} us/call)"
            for _, name in _TIMED))
    report = {"gpu": smi, "n_slots": N_SLOTS, "segment_steps": SEGMENT, "tick": tick}

    toks = torch.tensor(prompts[:GROUP], dtype=torch.int32, device=dev)
    lens = torch.full((GROUP,), LP, dtype=torch.int32, device=dev)
    slots = torch.arange(GROUP, dtype=torch.int32, device=dev)
    report["admission"] = _window(
        lambda: batching.prefill_slots(cfg, scfg, lay.speech_gen_end, eng.params, eng.state,
                                       toks, lens, slots),
        f"admission group [{GROUP}x{LP}]")
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
