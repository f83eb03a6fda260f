"""Staged decode attention (#2, int8 cache): the least time of the bytes the
slots' live lengths need (K, V and their scales of every attended token,
q in and the output out) at the card's bandwidth, over the kernel's device
time in the traced sub-window."""

from benchmark.harness import counts
from benchmark.harness.readers import roofline_pct


def read(run):
    if run.trace is None:
        return None
    return roofline_pct(run, ("staged_attention_kernel",), 0.0,
                        run.trace.notes.get("staged_attention_bytes", 0.0), counts.PEAK_INT8)
