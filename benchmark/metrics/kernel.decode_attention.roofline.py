"""Decode attention (#1, bf16 cache): the least time of the bytes of the
live cache (K and V of every attended token, q in, the output out) at the
card's bandwidth, over the kernel's device time in the traced sub-window."""

from benchmark.harness import counts
from benchmark.harness.readers import roofline_pct


def read(run):
    if run.trace is None:
        return None
    return roofline_pct(run, ("decode_attention_kernel",), 0.0,
                        run.trace.notes.get("decode_attention_bytes", 0.0), counts.PEAK_BF16)
