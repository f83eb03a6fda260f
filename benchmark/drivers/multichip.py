"""Serving cells over several cards: the port's `MultiChipEngine`, one
`Engine` replica per card, driven by one host thread through its own tick
(`MultiChipEngine.step`: every replica's segment dispatched, then each
collected), under a held backlog routed to the least-loaded replica. As in
`drivers/engine.py`: the first `replicas x n_slots` requests take budgets
spread over `first_wave_budget`, `warm_segments` ticks run in set-up, and
the window runs from a tick to the first tick at least `--seconds` later;
its rate is the useful tokens all replicas delivered over that time.

The device trace is read card by card (`CardsTrace`): each card's busy time
is the union of its own events, and `busy_s` is their mean, so an idle card
is not hidden behind a busy one. The check draws `check_requests` requests
of the window with at least `per_replica_check` from each replica, and the
longest.
"""

from __future__ import annotations

import gc
import time
from collections import defaultdict
from typing import Dict, List

import numpy as np
import torch

from benchmark.drivers import engine as base
from benchmark.harness import model, weights
from benchmark.harness import traffic as trafficlib
from benchmark.harness.record import Run
from benchmark.harness.trace import DeviceTrace, _union


class CardsTrace(DeviceTrace):
    """`DeviceTrace` over several cards: start and stop wait for every card;
    `notes["busy_by_card"]` holds each card's busy seconds (the union of its
    own events' intervals) and `busy_s` their mean."""

    def __init__(self, spans, devices):
        super().__init__(spans)
        self.devices = devices

    def _sync(self):
        for d in self.devices:
            torch.cuda.synchronize(d)

    def start(self) -> None:
        self._sync()
        super().start()

    def stop(self) -> None:
        self._sync()
        super().stop()

    def _reduce(self, events) -> None:
        cuda = torch.autograd.DeviceType.CUDA
        per: Dict[int, list] = defaultdict(list)
        for e in events:
            if e.device_type() == cuda and not getattr(e, "is_user_annotation", bool)():
                s = e.start_ns()
                per[int(e.device_index())].append((s, s + e.duration_ns()))
        super()._reduce(events)
        busy = {d: sum(b - a for a, b in _union(per.get(d.index, []))) / 1e9
                for d in self.devices}
        self.notes["busy_by_card"] = [busy[d] for d in self.devices]
        self.notes["cards"] = len(self.devices)
        self.busy_s = sum(busy.values()) / len(busy)


def build(cell_config: dict, t: dict, seed: int, devices):
    from neutts_tpu_torch.models import backbone as bb
    from neutts_tpu_torch.serving.multichip import MultiChipEngine

    c = cell_config
    model.set_precision_flags(c)
    cfg = model.backbone_config(c)
    params = weights.backbone_params(model.sizes(c), seed, devices[0], model.weight_dtype(c))
    if c["weights"] == "int8":
        params = bb.quantize_params(params)
    elif c["weights"] != "bf16":
        raise ValueError(f"{c['name']}: the engine serves bf16 or int8 weights, not "
                         f"{c['weights']!r}")
    sampling = model.sampling_config(c, cfg, min_new_tokens=max(t["budget"]) + 1)
    return MultiChipEngine(cfg, params, eos_id=cfg.layout.speech_gen_end,
                           n_slots=int(t["n_slots"]), devices=devices, sampling=sampling,
                           segment_steps=int(t["segment_steps"]), seed=int(seed) % (1 << 62))


def cards(device, n: int) -> list:
    """The run's cards: `n` CUDA devices from index 0, or the CPU `n` times."""
    if device.type == "cuda":
        return [torch.device("cuda", i) for i in range(n)]
    return [device] * n


def run(cell, seed: int, seconds: float, trace: bool, device, t_start: float) -> Run:
    from neutts_tpu_torch.ops import mlp as mlp_ops

    c, t = cell.config, cell.traffic
    rec = Run(cell=cell.name, config=c, traffic=t, sizes=model.sizes(c))
    devices = cards(device, int(t["replicas"]))
    mce = build(c, t, seed, devices)
    engines = mce.engines
    lay = engines[0].cfg.layout
    for eng in engines:
        base.warm_up(eng, t)
    slots = sum(e.n_slots for e in engines)
    reqs = trafficlib.engine_requests({**t, "n_slots": slots}, seed, lay.speech_base,
                                      lay.codebook_size)
    spans = rec.spans
    backlog = int(t["backlog"])
    info: Dict[tuple, dict] = {}  # (replica, local rid) -> {"req", "done", "tokens"}
    nxt = iter(reqs)
    clock = time.perf_counter
    is_cuda = device.type == "cuda"

    def top_up():
        while mce.pending() < slots + backlog:
            r = next(nxt, None)
            if r is None:
                raise RuntimeError(f"{t['name']}: the traffic list ran out; raise n_requests")
            with spans.span("engine.submit"):
                rid = mce.submit(r.prompt, max_new=r.budget)
            info[mce._route[rid]] = {"req": r, "done": None, "tokens": None, "replica":
                                     mce._route[rid][0]}

    def tick():
        top_up()
        with spans.span("multichip.step"):
            mce.step()
        now = clock()
        for i, eng in enumerate(engines):
            for done in eng.pop_finished():
                d = info[(i, done.rid)]
                d["done"], d["tokens"] = now, list(done.tokens)
        return now

    def useful():
        return sum(e.stats["useful_tokens"] for e in engines)

    tracer = CardsTrace(spans, devices) if trace and is_cuda else None
    trace_ticks = int(t.get("trace_segments", 2))
    rec.data["trace_segments"] = trace_ticks
    for _ in range(int(t.get("warm_segments", 2))):
        tick()
    t_open = tick()
    rec.setup_s = t_open - t_start
    spans.open = True
    gc.freeze()
    u0 = useful()
    traced = tracer is None
    while True:
        t_c = tick()
        if not traced and t_c - t_open >= seconds / 3:
            traced = True
            tracer.start()
            with base._Watch() as w:
                for _ in range(trace_ticks):
                    tick()
            tracer.stop()
            tracer.notes.update(w.counts(rec.sizes, lay.vocab_size - lay.speech_gen_end,
                                         mlp_ops.FUSED_MIN_M))
            continue
        if t_c - t_open >= seconds:
            t_close = t_c
            break
    spans.open = False
    rec.window_s = t_close - t_open
    rec.data["useful_tokens"] = useful() - u0
    rec.data["replicas"] = len(engines)
    rec.data["segments"] = len(spans.seconds.get("multichip.step", []))
    done = [d for d in info.values() if d["done"] is not None and t_open < d["done"] <= t_close]
    open_ = [d for d in info.values() if d["done"] is None]
    rec.data["requests_completed"] = len(done)
    rec.data["completed_by_replica"] = [sum(d["replica"] == i for d in done)
                                        for i in range(len(engines))]
    rec.attempted = len(done) + len(open_)
    rec.failed = sum(1 for d in done if not base._served_ok(d, lay))
    if is_cuda:
        for d in devices:
            torch.cuda.synchronize(d)
        rec.memory_peak_bytes = max(int(torch.cuda.max_memory_allocated(d)) for d in devices)
    if tracer is not None:
        tracer.finish()
    rec.trace = tracer
    rec.data["check_seqs"] = check_sample(done, len(engines), seed,
                                          int(t.get("check_requests", 16)),
                                          int(t.get("per_replica_check", 4)))
    del mce, engines, info
    gc.unfreeze()
    gc.collect()
    if is_cuda:
        torch.cuda.empty_cache()
    return rec


def check_sample(done: List[dict], replicas: int, seed: int, n: int, per_replica: int) -> list:
    """`per_replica` requests drawn from the seed among each replica's
    completed ones, then the rest of the `n` from all of them, and the
    longest: (prompt ids, served tokens) each."""
    rng = np.random.default_rng([int(seed) % (1 << 64), 7])
    pick = set()
    for i in range(replicas):
        mine = [j for j, d in enumerate(done) if d["replica"] == i]
        k = min(per_replica, len(mine))
        pick |= set(rng.choice(mine, size=k, replace=False).tolist()) if k else set()
    rest = [j for j in range(len(done)) if j not in pick]
    k = min(max(n - len(pick), 0), len(rest))
    pick |= set(rng.choice(rest, size=k, replace=False).tolist()) if k else set()
    if done:
        pick.add(max(range(len(done)), key=lambda j: len(done[j]["req"].prompt)
                     + len(done[j]["tokens"])))
    return [(done[j]["req"].prompt.tolist(), done[j]["tokens"]) for j in sorted(pick)]


compare = base.compare
