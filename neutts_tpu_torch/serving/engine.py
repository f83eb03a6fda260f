"""Continuous-batching serving engine (port of `neutts_tpu.serving.engine`):
slot admission and retirement around the decode core of
`neutts_tpu_torch.runtime.batching`.

Host/device split:
  * host: request queue, slot bookkeeping, result delivery;
  * device: all prefill/decode compute and sampling; the state never leaves
    the device between segments.

Usage:
    eng = Engine(cfg, params, n_slots=16, sampling=..., eos_id=...)   # device="cuda"
    rid = eng.submit(prompt_ids, max_new=700)
    results = eng.run()          # drain everything
    # or incrementally: eng.step(); eng.pop_finished()

A dispatch queues a whole segment without waiting for the device: inputs go
up from pinned host memory without blocking, and the segment's tokens come
back through a pinned copy queued right after the segment, so the pipelined
`run` overlaps the host's bookkeeping of segment N with the device's work on
segment N+1.

An LFM2-MoE config (`config.Lfm2Config`) is served the same way; its
per-expert row counts (`SlotState.expert_rows`) ride the segment's readback,
and `stats["expert_load_peak"]` gives the busiest expert's decode rows over
the mean, in percent (100 = even), averaged over the MoE layers.

Spans (`neutts_tpu_torch.utils`, recorded while the tracer is on):
`engine.dispatch` holds `engine.admit` (its `engine.prefill_group`s, each an
`admit.replay` on a card) and `batching.decode_steps` (a `decode.replay` on a
card, else its `decode.step`s); `engine.collect` holds
`readback.wait`; each request adds `engine.queue` (submit to admission) and
`engine.request` (submit to the collect that delivers it), keyed by its id.
"""

from __future__ import annotations

import dataclasses
import itertools
from collections import deque
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from neutts_tpu_torch.config import BackboneConfig, SamplingConfig, resolve_kv_dtype, round_up
from neutts_tpu_torch.models import backbone as bb
from neutts_tpu_torch.ops.attention import SEG_PAD
from neutts_tpu_torch.pipeline import resolve_device
from neutts_tpu_torch.runtime import batching
from neutts_tpu_torch.runtime.decode import bucket_length
from neutts_tpu_torch.utils import TRACER, clock_ns, span, traced


@dataclasses.dataclass
class Request:
    rid: int
    prompt_ids: List[int]
    max_new: int
    tokens: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    submit_ns: int = 0  # `clock_ns` at submit


def _to_device(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A host array on `dev`; to a GPU through pinned memory, without waiting
    for the stream (a blocking copy would wait for every queued segment)."""
    t = torch.from_numpy(a)
    return t.pin_memory().to(dev, non_blocking=True) if dev.type == "cuda" else t


class _Readback:
    """Device tensors copied to the host in stream order, at construction;
    `wait` blocks until those copies (not later work) are done."""

    def __init__(self, *tensors: torch.Tensor):
        self.event = None
        if tensors[0].is_cuda:
            self.host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in tensors]
            for h, t in zip(self.host, tensors):
                h.copy_(t, non_blocking=True)
            # on the tensors' own card: a replica of `MultiChipEngine` reads
            # back from a card that is not the current device
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(tensors[0].device))
        else:
            self.host = [t.clone() for t in tensors]

    @traced("readback.wait")
    def wait(self) -> List[np.ndarray]:
        if self.event is not None:
            self.event.synchronize()
        return [h.numpy() for h in self.host]


def expert_load_peak(rows: np.ndarray) -> Optional[float]:
    """rows [MoE layers, E] routed rows -> 100 x the busiest expert's rows
    over the mean, averaged over the layers that routed any (100 = even)."""
    rows = rows.astype(np.float64)
    mean = rows.mean(axis=1)
    ok = mean > 0
    if not ok.any():
        return None
    return float(100.0 * (rows.max(axis=1)[ok] / mean[ok]).mean())


class Engine:
    # admission group sizes, largest-fit first: bounds the padding waste of
    # steady-state drip admissions (1-2 freed slots per tick) while cold
    # starts and synchronized waves run wide groups
    ADMIT_GROUPS = (256, 64, 16, 4, 1)

    def __init__(
        self,
        cfg: BackboneConfig,
        params,
        *,
        eos_id: int,
        n_slots: int = 16,
        sampling: Optional[SamplingConfig] = None,
        segment_steps: int = 32,
        seed: int = 0,
        device="cuda",
    ):
        self.device = resolve_device(device)
        # kv_dtype="auto": slots live for any request mix, so it resolves
        # against the whole context window (int4, as in the JAX package)
        cfg = resolve_kv_dtype(cfg, cfg.max_context)
        self.cfg = cfg
        self.eos_id = eos_id
        self.n_slots = n_slots
        self.sampling = sampling or SamplingConfig()
        params = bb.prepare_params(params, self.device)
        # speech-constrained sampling gets the pre-sliced speech head: the
        # LM-head product and the top-k shrink to the speech vocabulary
        lay = cfg.layout
        if self.sampling.speech_range == (lay.speech_base, lay.vocab_size):
            params = bb.add_speech_head(cfg, params)
        self.params = params
        # admission buckets are 64-aligned and clamped to max_context; an
        # aligned max_context keeps every segment base aligned, as in the JAX
        # package, whose outputs and stats the port reproduces
        if cfg.max_context % 128 != 0:
            raise ValueError(
                f"max_context must be a multiple of 128 for serving (got {cfg.max_context})")
        # segments: a multiple of the staged alignment (SEGMENT_ALIGN, or
        # SEGMENT_ALIGN_INT4 for int4's token pairs) that fits the staging scales
        self.state = batching.SlotState.create(cfg, n_slots, self.device, seed=seed)
        align = batching.segment_align(self.state.cache)
        self.segment_steps = min(max(align, (segment_steps // align) * align), SEG_PAD)
        self._queue: deque[Request] = deque()
        self._slot_req: List[Optional[Request]] = [None] * n_slots
        self._finished: List[Request] = []
        self._ids = itertools.count()
        self._dispatch_id = itertools.count(1)
        # (dispatch token, {occupied slots}) of the dispatched-but-uncollected
        # segment, for predictive retirement (see step_dispatch)
        self._inflight: Optional[tuple] = None
        self._pending_first: Optional[torch.Tensor] = None
        self.reset_stats()

    def reset_stats(self) -> None:
        """Zero the throughput-tax counters (call between a warm-up run and
        the measured run); an LFM2 state's expert counts are zeroed on the
        device, in stream order."""
        if self.state.expert_rows is not None:
            self.state.expert_rows.zero_()
        self.stats = {
            "dispatched_token_slots": 0,  # segment_steps x n_slots per dispatch
            "useful_tokens": 0,  # tokens delivered to requests
            "post_done_token_slots": 0,  # slots decoding past their request's end
            "empty_token_slots": 0,  # never-occupied slots in a dispatch
            "post_eos_token_slots": 0,  # within-segment steps after a row's EOS
        }

    # --- API ------------------------------------------------------------------

    def submit(self, prompt_ids: Sequence[int], max_new: Optional[int] = None) -> int:
        if len(prompt_ids) >= self.cfg.max_context:
            raise ValueError(
                f"prompt of {len(prompt_ids)} tokens exceeds context {self.cfg.max_context}")
        cap = self.cfg.max_context - len(prompt_ids)
        req = Request(rid=next(self._ids), prompt_ids=list(map(int, prompt_ids)),
                      max_new=min(max_new or cap, cap), submit_ns=clock_ns())
        self._queue.append(req)
        return req.rid

    def pending(self) -> int:
        return len(self._queue) + sum(r is not None for r in self._slot_req)

    def pop_finished(self) -> List[Request]:
        out, self._finished = self._finished, []
        return out

    def step(self) -> None:
        """One engine tick: admit into free slots, decode one segment, retire."""
        pending = self.step_dispatch()
        if pending is not None:
            self.step_collect(pending)

    @traced("engine.dispatch")
    def step_dispatch(self):
        """Admission + decode-segment dispatch, without waiting for the
        device. Returns an opaque token for `step_collect`, or None if the
        engine is idle."""
        # PREDICTIVE RETIREMENT: a request whose budget is exhausted by the
        # in-flight (dispatched, uncollected) segment is guaranteed to finish
        # there; freeing its slot now lets this dispatch admit a queued
        # request one segment earlier. Stream order keeps it safe: the
        # in-flight segment's reconcile runs before this tick's admission
        # overwrites the slot.
        if self._inflight is not None:
            _, inflight_slots = self._inflight
            all_complete = True
            # cap frees at the queue depth: a slot freed but not re-admitted
            # is never retired and would keep decoding discarded tokens
            free_budget = len(self._queue)
            for slot, req in enumerate(self._slot_req):
                if req is None or req.done:
                    continue
                gain = self.segment_steps if slot in inflight_slots else 0
                if len(req.tokens) + gain >= req.max_new:
                    if free_budget > 0:
                        self._slot_req[slot] = None  # collect() finishes it
                        free_budget -= 1
                else:
                    all_complete = False
            if all_complete and not self._queue:
                # every occupied slot finishes in the in-flight segment and
                # nothing waits: another dispatch would be discarded work
                return None
        newly = self._admit()
        if not any(r is not None for r in self._slot_req):
            return None
        S = self.segment_steps
        self.stats["dispatched_token_slots"] += S * self.n_slots
        self.stats["empty_token_slots"] += S * sum(r is None for r in self._slot_req)
        with span("batching.decode_steps", steps=S):
            self.state, outs = batching.decode_steps(
                self.cfg, self.sampling, self.eos_id, S, self.params, self.state)
        # the segment's tokens and active flags, and the admission's first
        # tokens, go to the host in stream order, before any later dispatch
        extra = () if self.state.expert_rows is None else (self.state.expert_rows,)
        readback = _Readback(outs, self.state.active, self._pending_first, *extra)
        token = next(self._dispatch_id)
        self._inflight = (token, {i for i, r in enumerate(self._slot_req) if r is not None})
        # snapshot the slot->request mapping: a pipelined collect runs after
        # the next dispatch's admissions, and this segment's rows belong to
        # the requests that held the slots when it was dispatched
        return token, newly, readback, list(self._slot_req)

    @traced("engine.collect")
    def step_collect(self, pending) -> None:
        """Readback + bookkeeping for a `step_dispatch` result."""
        token, newly, readback, slot_req = pending
        delivered = len(self._finished)
        if self._inflight is not None and self._inflight[0] == token:
            self._inflight = None  # this dispatch is no longer in flight
        outs, active, first_tokens, *expert_rows = readback.wait()
        if expert_rows:
            self.stats["expert_load_peak"] = expert_load_peak(expert_rows[0][:, 0])
        retire: List[int] = []
        # admission-time first tokens (sampled inside prefill_slots)
        for slot, req in newly:
            t = int(first_tokens[slot])
            if t != self.eos_id:
                req.tokens.append(t)
                self.stats["useful_tokens"] += 1
            if t == self.eos_id or len(req.tokens) >= req.max_new:
                req.done = True
                if self._slot_req[slot] is req:
                    retire.append(slot)
                else:
                    # predictively freed (and maybe re-admitted): deliver only
                    self._finished.append(req)
        for slot, req in enumerate(slot_req):
            if req is None or req.done:
                if req is not None:  # finished in a prior segment, rode along
                    self.stats["post_done_token_slots"] += outs.shape[1]
                continue
            row = outs[slot]
            eos_at = np.flatnonzero(row == self.eos_id)
            end = int(eos_at[0]) if eos_at.size else len(row)
            take = min(end, req.max_new - len(req.tokens))
            req.tokens.extend(row[:take].tolist())
            self.stats["useful_tokens"] += take
            self.stats["post_eos_token_slots"] += len(row) - take
            if eos_at.size or len(req.tokens) >= req.max_new or not active[slot]:
                req.done = True
                if self._slot_req[slot] is req:
                    retire.append(slot)
                else:
                    self._finished.append(req)
        self._retire_batch(retire)
        for req in self._finished[delivered:]:
            TRACER.record("engine.request", req.submit_ns, key=req.rid)

    def run(self, pipelined: bool = True) -> Dict[int, List[int]]:
        """Drain queue and slots; returns {rid: generated tokens (no EOS)}.

        pipelined=True dispatches segment N+1 before segment N's readback and
        bookkeeping, so the device does not idle on the host's tick. A
        dispatch only admits into slots freed by collected segments (or
        predictively, see step_dispatch), so every retirement is queued
        before a prefill that reuses its slot. Rows that finish in segment N
        decode through N+1 with their tokens discarded."""
        if not pipelined:
            while self.pending():
                self.step()
            return {r.rid: r.tokens for r in self.pop_finished()}
        prev = None
        while True:
            pending = self.step_dispatch() if self.pending() else None
            if prev is not None:
                self.step_collect(prev)
            prev = pending
            if pending is None and not self.pending():
                break
        return {r.rid: r.tokens for r in self.pop_finished()}

    # --- internals ------------------------------------------------------------

    def _admit(self):
        """Prefill queued requests into free slots, grouped by bucket, with
        no wait on the device; their first tokens come back with the tick's
        readback. Returns [(slot, request)] for this tick's admissions."""
        with span("engine.admit") as sp:
            free = [s for s in range(self.n_slots) if self._slot_req[s] is None]
            newly = []
            by_bucket: Dict[int, List[tuple]] = {}
            n_groups = 0
            for slot in free:
                if not self._queue:
                    break
                req = self._queue.popleft()
                TRACER.record("engine.queue", req.submit_ns, key=req.rid)
                Lp = min(bucket_length(len(req.prompt_ids)), self.cfg.max_context)
                # a left pad past the cache slack could hit the physical bound
                # before the real-length cap: take the tightest 64-aligned bucket
                if Lp - len(req.prompt_ids) > batching.CACHE_SLACK - self.segment_steps:
                    Lp = min(round_up(len(req.prompt_ids), 64), self.cfg.max_context)
                by_bucket.setdefault(Lp, []).append((slot, req))
                self._slot_req[slot] = req
                newly.append((slot, req))
            for Lp, items in by_bucket.items():
                i = 0
                while i < len(items):
                    rem = len(items) - i
                    # pad up to a wider group only when the waste is small
                    # (<= G/4); else take the largest group that fits and loop
                    cover = (min(g for g in self.ADMIT_GROUPS if g >= rem)
                             if rem <= max(self.ADMIT_GROUPS) else max(self.ADMIT_GROUPS))
                    if rem <= cover <= rem + cover // 4:
                        G = cover
                    else:
                        G = max(g for g in self.ADMIT_GROUPS if g <= rem)
                    take = min(G, rem)
                    group = items[i: i + take]
                    i += take
                    # pad a partial group by repeating its last admission: the
                    # duplicate slot is written once (prefill_slots)
                    group = group + [group[-1]] * (G - len(group))
                    toks = np.zeros((G, Lp), np.int32)
                    lens = np.zeros((G,), np.int32)
                    slots = np.zeros((G,), np.int32)
                    for j, (slot, req) in enumerate(group):
                        toks[j, Lp - len(req.prompt_ids):] = req.prompt_ids  # LEFT pad
                        lens[j] = len(req.prompt_ids)
                        slots[j] = slot
                    real = sum(len(req.prompt_ids) for _, req in group[:take])
                    n_groups += 1
                    with span("engine.prefill_group", rows=G, bucket=Lp, real_tokens=real):
                        self.state = batching.prefill_slots(
                            self.cfg, self.sampling, self.eos_id, self.params, self.state,
                            _to_device(toks, self.device), _to_device(lens, self.device),
                            _to_device(slots, self.device))
            # snapshot on the stream, before the segment's decode replaces it
            self._pending_first = self.state.token.clone()
            sp.attrs.update(requests=len(newly), groups=n_groups)
            return newly

    def _retire_batch(self, slots: List[int]) -> None:
        if not slots:
            return
        for slot in slots:
            req = self._slot_req[slot]
            if req is not None:
                self._finished.append(req)
                self._slot_req[slot] = None
        mask = np.zeros((self.n_slots,), bool)
        mask[slots] = True
        self.state = batching.retire_slots(self.state, _to_device(mask, self.device))
