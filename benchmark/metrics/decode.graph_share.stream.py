"""Share of the stream's decode segments that replayed a captured CUDA graph:
100 x the program's `decode.replay` spans over its `decode.segment` spans in
the traced sub-window (`harness/program.py`); the rest ran eagerly or were
captured. None without `decode.segment` spans."""

from benchmark.harness import program


def read(run):
    segments = len(program.named(run, "decode.segment"))
    if not segments:
        return None
    return 100.0 * len(program.named(run, "decode.replay")) / segments
