"""Model FLOPs of the rows all replicas decoded and the prompt tokens they
prefilled in the traced sub-window, over its unprofiled length at the peak
of all the run's cards (each at 1,979 TOP/s int8, else 989 TFLOP/s bf16):
the whole host's share of its cards' peak."""

from benchmark.harness import counts


def read(run):
    tr = run.trace
    if tr is None or not tr.unprofiled_s or not tr.notes.get("model_flops"):
        return None
    cards = tr.notes.get("cards", 1)
    return 100.0 * tr.notes["model_flops"] / (tr.unprofiled_s * cards * counts.peak(run.config))
