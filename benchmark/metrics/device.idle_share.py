"""Share of the traced sub-window in which no operation ran on the card:
1 - (union of the device events' intervals) / (the sub-window's length with
each profiled span at its unprofiled median, `harness/trace.py`)."""

from benchmark.harness.readers import idle_pct


def read(run):
    return idle_pct(run)
