"""Multi-head latent attention decode kernel (`csrc/mla_decode.cu`): the
least time of its bytes (every attended latent row's 576 int8 values and
its scale, the bf16 query in and the bf16 latent output out; the staging
columns count as rows) and its bf16 FLOPs (16 heads x (576 + 512) x 2 a
row), bytes bounding, over the kernel's device time in the traced
sub-window, at 3.35 TB/s and 989 TFLOP/s. `drivers/engine_moonlight.py`
counts them (`harness/moonlight.py`). None where no such kernel ran."""

from benchmark.harness import counts
from benchmark.harness.readers import roofline_pct


def read(run):
    if run.trace is None:
        return None
    n = run.trace.notes
    return roofline_pct(run, ("mla_decode_kernel",), n.get("mla_decode_flops", 0.0),
                        n.get("mla_decode_bytes", 0.0), counts.PEAK_BF16)
