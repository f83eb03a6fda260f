"""Grouped SwiGLU expert kernel (`csrc/moe.cu`, decode and admissions): the
least time of its bf16 FLOPs (2 x 3 x D x Fe a pair) and bytes (the weights
of the experts that took rows, once a call, and each pair's input and
output row) over the device time of its gate/up and down kernels in the
traced sub-window, at the bf16 peak of 989 TFLOP/s. `drivers/engine_lfm2.py` counts them
(`harness/lfm2.py`)."""

from benchmark.harness import counts
from benchmark.harness.readers import roofline_pct


def read(run):
    if run.trace is None:
        return None
    n = run.trace.notes
    return roofline_pct(run, ("moe_gate_up_kernel", "moe_down_kernel"),
                        n.get("moe_expert_flops", 0.0), n.get("moe_expert_bytes", 0.0),
                        counts.PEAK_BF16)
