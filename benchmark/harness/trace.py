"""Host-clock spans over the whole window, and `torch.profiler` over a short
steady sub-window of a traced run.

Spans are recorded by the benchmark's own files around its calls into the
program's layers (the program has no spans of its own yet). Their durations
are kept only for the part of the window the profiler does not cover, so a
per-layer time is never read off a profiled tick. While the profiler is on,
the same spans are kept as marks on the wall clock instead, and each idle
gap of the device is put down to the innermost mark around it.

The profiler records the device's activity alone: no host operators and no
`record_function` ranges. Its tracing of each launch still slows the host's
launch loop (on an H100, a 25-step chunk by 1.2-1.3x and a serving segment
by 1.3-1.6x), so the shares of the sub-window's time that the readers give
are taken over `unprofiled_s`: the sub-window with each profiled span at its
median outside the profiler in the same run. No Chrome trace is written:
the events are reduced in memory.
"""

from __future__ import annotations

import statistics
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple

import torch


class Spans:
    """Durations (seconds) by span name over the window outside the profiled
    sub-window, and marks (name, start ns, end ns on the wall clock, the
    profiler's time base) inside it."""

    def __init__(self):
        self.seconds: Dict[str, List[float]] = defaultdict(list)
        self.marks: List[Tuple[str, int, int]] = []
        self.open = False  # record only while the window is open
        self.profiling = False

    @contextmanager
    def span(self, name: str):
        if not (self.open or self.profiling):
            yield
            return
        profiling = self.profiling
        t0, w0 = time.perf_counter(), time.time_ns()
        try:
            yield
        finally:
            if profiling:
                self.marks.append((name, w0, time.time_ns()))
            elif self.open:
                self.seconds[name].append(time.perf_counter() - t0)

    def mean(self, name: str) -> Optional[float]:
        v = self.seconds.get(name)
        return sum(v) / len(v) if v else None


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def _outermost(marks: List[Tuple[str, int, int]]) -> List[Tuple[str, int, int]]:
    """The marks that no other mark contains."""
    return [m for m in marks
            if not any(o is not m and o[1] <= m[1] and m[2] <= o[2] for o in marks)]


class DeviceTrace:
    """The profiler over one sub-window: `start()` and `stop()` each wait for
    the device, so the sub-window's wall time holds all of its work."""

    def __init__(self, spans: Spans):
        self.spans = spans
        self.prof = None
        self.kernels: List[Tuple[str, int, int]] = []  # (name, start ns, end ns)
        self.window_s = None
        self.busy_s = None
        self.breakdown = None
        self.parse_s = None
        self.inside_share = None  # of the busy time, the share between start and stop
        self.unprofiled_s = None
        self.notes: Dict[str, object] = {}  # counts the driver keeps for readers

    def start(self) -> None:
        torch.cuda.synchronize()
        self.prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
        self.prof.start()
        self.spans.profiling = True
        self._t0, self._w0 = time.perf_counter(), time.time_ns()

    def stop(self) -> None:
        torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self._t0
        self._w1 = time.time_ns()
        self.spans.profiling = False
        self.prof.stop()

    def finish(self) -> None:
        """Reduces the events; called once the measured window has closed,
        so that the reduction's seconds fall outside it."""
        if self.prof is None:
            return
        t0 = time.perf_counter()
        self._reduce(self.prof.profiler.kineto_results.events())
        self.prof = None
        self.parse_s = time.perf_counter() - t0
        self.unprofiled_s = self.window_s - self.profiler_delay_s()

    def profiler_delay_s(self) -> float:
        """Seconds by which the profiled spans (the outermost) outlast their
        medians outside the profiler in the same run."""
        return sum((b - a) / 1e9 - statistics.median(self.spans.seconds[n])
                   for n, a, b in _outermost(self.spans.marks) if self.spans.seconds.get(n))

    def _reduce(self, events) -> None:
        cuda = torch.autograd.DeviceType.CUDA
        dev = []
        for e in events:
            if e.device_type() == cuda and not getattr(e, "is_user_annotation", bool)():
                s = e.start_ns()
                dev.append((e.name(), s, s + e.duration_ns()))
        self.kernels = dev
        merged = _union([(s, e) for _, s, e in dev])
        busy = sum(e - s for s, e in merged)
        self.busy_s = busy / 1e9
        inside = sum(max(0, min(e, self._w1) - max(s, self._w0)) for s, e in merged)
        self.inside_share = inside / busy if busy else None
        by_op: Dict[str, float] = defaultdict(float)
        for name, s, e in dev:
            by_op[name] += (e - s) / 1e9
        gaps: Dict[str, float] = defaultdict(float)
        marks = sorted(self.spans.marks, key=lambda x: x[2] - x[1])  # innermost first
        for (s0, e0), (s1, _) in zip(merged, merged[1:]):
            mid = (e0 + s1) // 2
            who = next((n for n, a, b in marks if a <= mid < b), "host, outside any span")
            gaps[who] += (s1 - e0) / 1e9
        top = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
        self.breakdown = {
            "device_ops": [[n[:120], v] for n, v in top],
            "idle_gaps": [[n, v] for n, v in sorted(gaps.items(), key=lambda kv: -kv[1])[:10]],
        }

    def stretch(self) -> Dict[str, float]:
        """For each span, its median inside the profiled sub-window over its
        median outside: how far the profiler slows the host (1 = not at all)."""
        inside: Dict[str, List[float]] = defaultdict(list)
        for name, a, b in self.spans.marks:
            inside[name].append((b - a) / 1e9)
        return {n: statistics.median(v) / statistics.median(self.spans.seconds[n])
                for n, v in inside.items() if self.spans.seconds.get(n)}

    def device_seconds(self, *needles: str) -> Optional[float]:
        """Device seconds of the kernels whose names hold any of `needles`."""
        t = sum(e - s for n, s, e in self.kernels if any(k in n for k in needles))
        return t / 1e9 if t > 0 else None
