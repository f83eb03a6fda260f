"""The busiest expert's decode rows over the mean, in percent (100 = an even
load), averaged over the MoE layers: `Engine.stats["expert_load_peak"]`,
from the device's per-expert row counts, read at the segments' readback,
over the run since set-up's warm-up."""


def read(run):
    return run.data.get("expert_load_peak")
