"""Arithmetic the metric readers share: tails with the requests still open
at the close, and shares of the card's roofline and peak."""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from benchmark.harness import counts


def _with_open(done: Sequence[float], still_open: Sequence[float]) -> list:
    """The completed values, and each value still open at the close at its
    age where that exceeds every completed one: a stall moves the result
    although its request never ends."""
    worst = max(done) if len(done) else 0.0
    return list(done) + [a for a in still_open if a > worst]


def tail(done: Sequence[float], still_open: Sequence[float], q: float) -> Optional[float]:
    """The q-th percentile (linear) of `_with_open`."""
    vals = _with_open(done, still_open)
    return float(np.percentile(vals, q)) if vals else None


def roofline_pct(run, needles: Sequence[str], ops: float, nbytes: float,
                 peak: float) -> Optional[float]:
    """100 x the least time of the work over the device time of the kernels
    whose names hold any of `needles`, in the traced sub-window."""
    tr = run.trace
    if tr is None or (ops <= 0 and nbytes <= 0):
        return None
    t = tr.device_seconds(*needles)
    if not t:
        return None
    return 100.0 * counts.bound_s(ops, nbytes, peak) / t


def mfu_pct(run, peak: float) -> Optional[float]:
    """100 x the model FLOPs of the traced sub-window over its unprofiled
    length at `peak`."""
    tr = run.trace
    if tr is None or not tr.unprofiled_s or not tr.notes.get("model_flops"):
        return None
    return 100.0 * tr.notes["model_flops"] / (tr.unprofiled_s * peak)


def idle_pct(run) -> Optional[float]:
    """100 x the share of the traced sub-window's unprofiled length in which
    no operation ran on the card."""
    tr = run.trace
    if tr is None or not tr.unprofiled_s:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.unprofiled_s)
