"""Share of the serving admissions that replayed a captured CUDA graph: 100 x
the program's `admit.replay` spans over its `engine.prefill_group` spans in
the traced sub-window (`harness/program.py`); the rest ran eagerly or were
captured. None without `engine.prefill_group` spans."""

from benchmark.harness import program


def read(run):
    groups = len(program.named(run, "engine.prefill_group"))
    if not groups:
        return None
    return 100.0 * len(program.named(run, "admit.replay")) / groups
