"""Serving cells: the port's continuous-batching `Engine`, driven in the
pipelined order of `Engine.run` (dispatch segment N+1, then collect N),
under a held backlog: the queue is topped up before every dispatch so that
at least `backlog` requests wait. The first `n_slots` requests take budgets
spread over `first_wave_budget`, so the slots retire at a steady rate, and
`warm_segments` segments run in set-up. The window opens at a collect and
closes at the first collect at least `--seconds` later; its rate is the
useful tokens those collects delivered over the time between them.

Set-up warms every admission shape the mix uses (each group size of the
engine at each prompt bucket) and one decode segment, on the engine's own
state, before the first request.
"""

from __future__ import annotations

import gc
import math
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark.harness import check, counts, model, weights
from benchmark.harness import traffic as trafficlib
from benchmark.harness.record import Run
from benchmark.harness.trace import DeviceTrace


def build(cell_config: dict, t: dict, seed: int, device):
    from neutts_tpu_torch.models import backbone as bb
    from neutts_tpu_torch.serving.engine import Engine

    c = cell_config
    model.set_precision_flags(c)
    cfg = model.backbone_config(c)
    params = weights.backbone_params(model.sizes(c), seed, device, model.weight_dtype(c))
    if c["weights"] == "int8":
        params = bb.quantize_params(params)
    elif c["weights"] != "bf16":
        raise ValueError(f"{c['name']}: the engine serves bf16 or int8 weights, not "
                         f"{c['weights']!r}")
    sampling = model.sampling_config(c, cfg, min_new_tokens=max(t["budget"]) + 1)
    eng = Engine(cfg, params, eos_id=cfg.layout.speech_gen_end, n_slots=int(t["n_slots"]),
                 sampling=sampling, segment_steps=int(t["segment_steps"]),
                 seed=int(seed) % (1 << 63), device=device)
    return eng


def prompt_buckets(eng, lo: int, hi: int) -> List[int]:
    from neutts_tpu_torch.runtime.decode import bucket_length

    return sorted({min(bucket_length(n), eng.cfg.max_context) for n in range(lo, hi + 1)})


def warm_up(eng, t: dict) -> None:
    """Each admission group size at each prompt bucket of the mix, and one
    decode segment, on the engine's state; then every slot retired."""
    from neutts_tpu_torch.runtime import batching

    dev = eng.device
    lay = eng.cfg.layout
    groups = [g for g in eng.ADMIT_GROUPS if g <= eng.n_slots]
    lo, hi = t["prompt_tokens"]
    everyone = torch.ones(eng.n_slots, dtype=torch.bool, device=dev)
    for Lp in prompt_buckets(eng, lo, hi):
        for G in groups:
            toks = torch.full((G, Lp), lay.speech_base, dtype=torch.int32, device=dev)
            lens = torch.full((G,), min(Lp, hi), dtype=torch.int32, device=dev)
            slots = torch.arange(G, dtype=torch.int32, device=dev)
            eng.state = batching.prefill_slots(eng.cfg, eng.sampling, eng.eos_id, eng.params,
                                               eng.state, toks, lens, slots)
    eng.state, _ = batching.decode_steps(eng.cfg, eng.sampling, eng.eos_id, eng.segment_steps,
                                         eng.params, eng.state)
    eng.state = batching.retire_slots(eng.state, everyone)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    eng.reset_stats()


class _Watch:
    """Wraps the decode core's segment and admission calls while the device
    trace is on, keeping their inputs (device tensors that are replaced,
    never written in place) to count the work after the trace stops."""

    def __init__(self):
        from neutts_tpu_torch.runtime import batching

        self.mod = batching
        self.orig = (batching.decode_steps, batching.prefill_slots)
        self.segments: List[tuple] = []  # (n_steps, base lens, pad, active)
        self.admissions: List[tuple] = []  # (G, Lp, true lens, slots)

    def __enter__(self):
        dec, pre = self.orig

        def decode_steps(cfg, sampling, eos_id, n_steps, params, state):
            self.segments.append((n_steps, state.lens, state.pad, state.active))
            return dec(cfg, sampling, eos_id, n_steps, params, state)

        def prefill_slots(cfg, sampling, eos_id, params, state, tokens, true_lens, slots):
            self.admissions.append((tokens.shape[0], tokens.shape[1], true_lens, slots))
            return pre(cfg, sampling, eos_id, params, state, tokens, true_lens, slots)

        self.mod.decode_steps, self.mod.prefill_slots = decode_steps, prefill_slots
        return self

    def __exit__(self, *exc):
        self.mod.decode_steps, self.mod.prefill_slots = self.orig

    def counts(self, m: dict, head_columns: int, fused_min_rows: int) -> Dict[str, float]:
        """Work of the watched calls: model FLOPs of the rows decoded and the
        prompt tokens prefilled; the staged attention's bytes for the live
        lengths; #6's operations and bytes over the admitted real rows."""
        L = m["num_hidden_layers"]
        flops = attn_bytes = mlp_ops = mlp_bytes = 0.0
        decoded = prefilled = 0
        for S, lens, pad, active in self.segments:
            live0 = (lens - pad).cpu().numpy().astype(np.float64)
            act = active.cpu().numpy()
            rows = int(act.sum())
            base = float(live0[act].sum())
            keys = S * base + rows * S * (S + 1) / 2.0  # sum over steps of attended tokens
            decoded += rows * S
            flops += rows * S * counts.dense_flops_per_token(m, head_columns)
            flops += counts.attention_flops(m, keys)
            attn_bytes += L * (counts.staged_attention_bytes(m, keys, rows * S))
        for G, Lp, true_lens, slots in self.admissions:
            tl = true_lens.cpu().numpy()
            sl = slots.cpu().numpy()
            _, first = np.unique(sl, return_index=True)
            real = tl[first].astype(np.float64)
            prefilled += int(real.sum())
            flops += real.sum() * counts.dense_flops_per_token(m, 0)
            flops += len(real) * 2.0 * m["hidden_size"] * head_columns
            flops += counts.attention_flops(m, sum(counts.prefill_attention_keys(n)
                                                  for n in real))
            if G * Lp >= fused_min_rows:
                mlp_ops += L * counts.fused_mlp_ops(m, real.sum())
                mlp_bytes += L * counts.fused_mlp_bytes(m, real.sum())
        return {"model_flops": flops, "staged_attention_bytes": attn_bytes,
                "fused_mlp_ops": mlp_ops, "fused_mlp_bytes": mlp_bytes,
                "decoded_rows": decoded, "prefilled_tokens": prefilled}


def run(cell, seed: int, seconds: float, trace: bool, device, t_start: float) -> Run:
    from neutts_tpu_torch.ops import mlp as mlp_ops

    c, t = cell.config, cell.traffic
    rec = Run(cell=cell.name, config=c, traffic=t, sizes=model.sizes(c))
    eng = build(c, t, seed, device)
    lay = eng.cfg.layout
    warm_up(eng, t)
    reqs = trafficlib.engine_requests(t, seed, lay.speech_base, lay.codebook_size)
    spans = rec.spans
    n_slots, backlog = eng.n_slots, int(t["backlog"])
    info: Dict[int, dict] = {}  # rid -> {"req", "done", "tokens"}
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

    # the loop of Engine.run, one tick: top the queue up, dispatch, collect
    # the previous segment
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
    while True:  # open the window at a collect
        t_open = tick()
        if t_open is not None:
            break
    rec.setup_s = t_open - t_start
    spans.open = True
    gc.freeze()  # set-up's objects stay out of the window's collections
    u0, d0 = eng.stats["useful_tokens"], eng.stats["dispatched_token_slots"]
    traced = tracer is None
    while True:
        t_c = tick()
        if t_c is None:
            continue
        if not traced and t_c - t_open >= seconds / 3:
            # `trace_ticks` ticks under the profiler, with their work counted
            traced = True
            tracer.start()
            with _Watch() as w:
                for _ in range(trace_ticks):
                    tick()
            tracer.stop()
            tracer.notes.update(w.counts(rec.sizes, eng.cfg.vocab_size - lay.speech_gen_end,
                                         mlp_ops.FUSED_MIN_M))
            continue
        if t_c - t_open >= seconds:
            t_close = t_c
            break
    spans.open = False
    rec.window_s = t_close - t_open
    rec.data["useful_tokens"] = eng.stats["useful_tokens"] - u0
    rec.data["dispatched_token_slots"] = eng.stats["dispatched_token_slots"] - d0
    rec.data["segments"] = len(spans.seconds.get("engine.step_dispatch", []))
    # the window's requests: those it completed, and those still open at the close
    done = [d for d in info.values() if d["done"] is not None and t_open < d["done"] <= t_close]
    open_ = [d for d in info.values() if d["done"] is None]
    rec.data["requests_completed"] = len(done)
    rec.attempted = len(done) + len(open_)
    rec.failed = sum(1 for d in done if not _served_ok(d, lay))
    if is_cuda:
        torch.cuda.synchronize(eng.device)
        rec.memory_peak_bytes = int(torch.cuda.max_memory_allocated(eng.device))
    if tracer is not None:
        tracer.finish()
    rec.trace = tracer

    # correctness: a sample drawn from the seed of the window's requests,
    # with the longest among them; the program is freed first
    rng = np.random.default_rng([int(seed) % (1 << 64), 7])
    n_check = min(int(t.get("check_requests", 16)), len(done))
    longest = max(range(len(done)), key=lambda i: len(done[i]["req"].prompt)
                  + len(done[i]["tokens"])) if done else None
    pick = set(rng.choice(len(done), size=n_check, replace=False).tolist()) if n_check else set()
    if longest is not None:
        pick.add(longest)
    seqs = [(done[i]["req"].prompt.tolist(), done[i]["tokens"]) for i in sorted(pick)]
    rec.data["check_seqs"] = seqs
    del eng, info, state
    gc.unfreeze()
    gc.collect()
    if is_cuda:
        torch.cuda.empty_cache()
    return rec


def _served_ok(d: dict, lay) -> bool:
    toks = d["tokens"]
    return len(toks) == d["req"].budget and all(
        lay.speech_base <= x < lay.vocab_size for x in toks)


def compare(rec: Run, seed: int, device, control: dict | None = None) -> Dict[str, float]:
    """The reference over the checked requests (weights made again from the
    seed); the control's reading too when `control` names its precision."""
    c = rec.config
    raw = weights.backbone_params(rec.sizes, seed, device, model.weight_dtype(c))
    lay_base = c["text_tokens"] + c["special_tokens"]  # <|speech_0|>
    seqs = rec.data["check_seqs"]
    if not seqs:
        return {"token_gap": math.inf}
    return check.token_gaps(rec.sizes, raw, seqs, check.reference_precision(c), lay_base,
                            c["vocab_size"], control=control)
