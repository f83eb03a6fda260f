"""Serving cells of an LFM2-MoE configuration: the port's `Engine` over
`config.Lfm2Config`, driven as `drivers/engine.py` drives the Qwen2 cells
(the pipelined order of `Engine.run` under a held backlog, the first wave's
budgets spread, `warm_segments` in set-up, the window from a collect to the
first collect `--seconds` later), with the LFM2 model's configuration,
weights, counts and plain reference (`harness/lfm2.py`,
`reference/lfm2.py`).

Besides the Qwen2 cells' numbers it keeps the engine's expert load
(`Engine.stats["expert_load_peak"]`) and, for the traced ticks, the grouped
expert kernel's operations and bytes and the staged attention's bytes over
the attention layers.
"""

from __future__ import annotations

import gc
import math
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark.drivers import engine as base
from benchmark.harness import counts, lfm2, model
from benchmark.harness import traffic as trafficlib
from benchmark.harness.record import Run
from benchmark.harness.trace import DeviceTrace
from benchmark.reference import lfm2 as reference


def build(cell_config: dict, t: dict, seed: int, device):
    from neutts_tpu_torch.models import lfm2 as _port_lfm2  # noqa: F401 (the port's LFM2 block)
    from neutts_tpu_torch.serving.engine import Engine

    c = cell_config
    if c["weights"] != "bf16":
        raise ValueError(f"{c['name']}: the LFM2 block serves bf16 weights, not {c['weights']!r}")
    model.set_precision_flags(c)
    cfg = lfm2.backbone_config(c)
    params = lfm2.params(lfm2.sizes(c), seed, device, model.weight_dtype(c))
    sampling = model.sampling_config(c, cfg, min_new_tokens=max(t["budget"]) + 1)
    return Engine(cfg, params, eos_id=cfg.layout.speech_gen_end, n_slots=int(t["n_slots"]),
                  sampling=sampling, segment_steps=int(t["segment_steps"]),
                  seed=int(seed) % (1 << 63), device=device)


class _Watch(base._Watch):
    """The watch of `drivers/engine.py`, counting the LFM2 model's work: model FLOPs
    with the active experts; the staged attention's bytes (#2, the
    attention layers alone); the grouped expert kernel's FLOPs and bytes,
    where each decode step reads the weights of the experts that took rows
    in that step (the device's count of them, `SlotState.expert_rows[:, 1]`,
    read before and after) and an admission those of every expert."""

    def __init__(self, state):
        super().__init__()
        self.state = state
        self.rows0 = state.expert_rows.clone()

    def lfm2_counts(self, m: dict, head_columns: int) -> Dict[str, float]:
        k, E = m["num_experts_per_tok"], m["num_experts"]
        n_moe = m["num_hidden_layers"] - m["num_dense_layers"]
        n_attn = sum(t == "full_attention" for t in m["layer_types"])
        flops = ex_flops = ex_bytes = attn_bytes = 0.0
        decoded = prefilled = 0
        # (step, MoE layer, expert) triples in which the expert took rows
        touched = int((self.state.expert_rows - self.rows0)[:, 1].sum())
        for S, lens, pad, active in self.segments:
            live0 = (lens - pad).cpu().numpy().astype(np.float64)
            act = active.cpu().numpy()
            rows = int(act.sum())
            keys = S * float(live0[act].sum()) + rows * S * (S + 1) / 2.0
            decoded += rows * S
            flops += rows * S * lfm2.flops_per_token(m, head_columns)
            flops += lfm2.attention_flops(m, keys)
            attn_bytes += n_attn * counts.staged_attention_bytes(m, keys, rows * S)
            ex_flops += lfm2.expert_flops(m, rows * S * k) * n_moe
            ex_bytes += n_moe * S * rows * k * 6.0 * m["hidden_size"]
        # each step reads the weights of each MoE layer's touched experts once
        ex_bytes += touched * lfm2.expert_matrix_bytes(m)
        for G, Lp, true_lens, slots in self.admissions:
            tl, sl = true_lens.cpu().numpy(), slots.cpu().numpy()
            _, first = np.unique(sl, return_index=True)
            real = tl[first].astype(np.float64)
            prefilled += int(real.sum())
            flops += real.sum() * lfm2.flops_per_token(m, 0)
            flops += len(real) * 2.0 * m["hidden_size"] * head_columns
            flops += lfm2.attention_flops(m, float((real * (real + 1) / 2.0).sum()))
            ex_flops += lfm2.expert_flops(m, real.sum() * k) * n_moe
            ex_bytes += n_moe * lfm2.expert_bytes(m, E, real.sum() * k)
        return {"model_flops": flops, "moe_expert_flops": ex_flops, "moe_expert_bytes": ex_bytes,
                "staged_attention_bytes": attn_bytes, "decoded_rows": decoded,
                "prefilled_tokens": prefilled}


def run(cell, seed: int, seconds: float, trace: bool, device, t_start: float) -> Run:
    c, t = cell.config, cell.traffic
    rec = Run(cell=cell.name, config=c, traffic=t, sizes=lfm2.sizes(c))
    eng = build(c, t, seed, device)
    lay = eng.cfg.layout
    base.warm_up(eng, t)
    reqs = trafficlib.engine_requests(t, seed, lay.speech_base, lay.codebook_size)
    spans = rec.spans
    n_slots, backlog = eng.n_slots, int(t["backlog"])
    info: Dict[int, dict] = {}
    nxt = iter(reqs)
    clock = time.perf_counter
    is_cuda = eng.device.type == "cuda"

    def submit(r):
        with spans.span("engine.submit"):
            rid = eng.submit(r.prompt, max_new=r.budget)
        info[rid] = {"req": r, "done": None, "tokens": None}

    def top_up():
        while eng.pending() < n_slots + backlog:
            r = next(nxt, None)
            if r is None:
                raise RuntimeError(f"{t['name']}: the traffic list ran out; raise n_requests")
            submit(r)

    def collect(pending):
        with spans.span("engine.step_collect"):
            eng.step_collect(pending)
        now = clock()
        for done in eng.pop_finished():
            d = info[done.rid]
            d["done"], d["tokens"] = now, list(done.tokens)
        return now

    state = {"prev": None}

    def tick():
        top_up()
        with spans.span("engine.step_dispatch"):
            pending = eng.step_dispatch() if eng.pending() else None
        t_c = collect(state["prev"]) if state["prev"] is not None else None
        state["prev"] = pending
        return t_c

    tracer = DeviceTrace(spans) if trace and is_cuda else None
    trace_ticks = int(t.get("trace_segments", 2))
    rec.data["trace_segments"] = trace_ticks

    for _ in range(int(t.get("warm_segments", 2)) + 1):
        tick()
    while True:
        t_open = tick()
        if t_open is not None:
            break
    rec.setup_s = t_open - t_start
    spans.open = True
    gc.freeze()
    u0, d0 = eng.stats["useful_tokens"], eng.stats["dispatched_token_slots"]
    traced = tracer is None
    while True:
        t_c = tick()
        if t_c is None:
            continue
        if not traced and t_c - t_open >= seconds / 3:
            traced = True
            tracer.start()
            with _Watch(eng.state) as w:
                for _ in range(trace_ticks):
                    tick()
                tracer.stop()
                tracer.notes.update(w.lfm2_counts(rec.sizes, eng.cfg.vocab_size
                                                  - lay.speech_gen_end))
            continue
        if t_c - t_open >= seconds:
            t_close = t_c
            break
    spans.open = False
    rec.window_s = t_close - t_open
    rec.data["useful_tokens"] = eng.stats["useful_tokens"] - u0
    rec.data["dispatched_token_slots"] = eng.stats["dispatched_token_slots"] - d0
    rec.data["segments"] = len(spans.seconds.get("engine.step_dispatch", []))
    rec.data["expert_load_peak"] = eng.stats.get("expert_load_peak")
    done = [d for d in info.values() if d["done"] is not None and t_open < d["done"] <= t_close]
    open_ = [d for d in info.values() if d["done"] is None]
    rec.data["requests_completed"] = len(done)
    rec.attempted = len(done) + len(open_)
    rec.failed = sum(1 for d in done if not base._served_ok(d, lay))
    if is_cuda:
        torch.cuda.synchronize(eng.device)
        rec.memory_peak_bytes = int(torch.cuda.max_memory_allocated(eng.device))
    if tracer is not None:
        tracer.finish()
    rec.trace = tracer
    rec.data["check_seqs"] = check_sample(done, seed, int(t.get("check_requests", 16)))
    del eng, info, state
    gc.unfreeze()
    gc.collect()
    if is_cuda:
        torch.cuda.empty_cache()
    return rec


def check_sample(done: List[dict], seed: int, n: int) -> list:
    """A sample drawn from the seed of the window's completed requests, with
    the longest among them: (prompt ids, served tokens) each."""
    rng = np.random.default_rng([int(seed) % (1 << 64), 7])
    n_check = min(n, len(done))
    pick = set(rng.choice(len(done), size=n_check, replace=False).tolist()) if n_check else set()
    if done:
        pick.add(max(range(len(done)), key=lambda i: len(done[i]["req"].prompt)
                     + len(done[i]["tokens"])))
    return [(done[i]["req"].prompt.tolist(), done[i]["tokens"]) for i in sorted(pick)]


def compare(rec: Run, seed: int, device, control: dict | None = None) -> Dict[str, float]:
    """The LFM2 reference over the checked requests (weights made again from
    the seed); the control's reading too when `control` names its precision."""
    c = rec.config
    seqs = rec.data["check_seqs"]
    if not seqs:
        return {"token_gap": math.inf}
    raw = lfm2.params(rec.sizes, seed, device, model.weight_dtype(c))
    lay_base = c["text_tokens"] + c["special_tokens"]  # <|speech_0|>
    prec = {"weights_mode": c["weights"], "act": c.get("activations"),
            "kv": None if c["kv_dtype"] in ("bfloat16", "float32") else c["kv_dtype"]}
    return reference.token_gaps(rec.sizes, raw, seqs, prec, lay_base, c["extended_vocab_size"],
                                control=control)
