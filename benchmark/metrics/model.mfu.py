"""Model FLOPs of the rows decoded and the prompt tokens prefilled in the
traced sub-window (projections, MLP, head, attention), over its length with
each profiled span at its unprofiled median, against the card's peak in the
precision the configuration's weights are served in: 1,979 TOP/s int8,
else 989 TFLOP/s bf16."""

from benchmark.harness import counts
from benchmark.harness.readers import mfu_pct


def read(run):
    return mfu_pct(run, counts.peak(run.config))
