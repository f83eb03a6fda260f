"""Fused W8A8 MLP (#6, admissions): the least time of the int8 operations
and bytes of the admitted groups' real rows, over the device time of its
gate/up and down products in the traced sub-window."""

from benchmark.harness import counts
from benchmark.harness.readers import roofline_pct


def read(run):
    if run.trace is None:
        return None
    n = run.trace.notes
    return roofline_pct(run, ("EpiGateUpTC", "EpiDownTC"), n.get("fused_mlp_ops", 0.0),
                        n.get("fused_mlp_bytes", 0.0), counts.PEAK_INT8)
