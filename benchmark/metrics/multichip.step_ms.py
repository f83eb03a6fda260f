"""Mean host milliseconds of one `MultiChipEngine.step` (the harness's
`multichip.step` span: every replica's admission and segment dispatched,
then each replica's previous segment collected), over the window's ticks
outside the profiled sub-window. A faster tick lowers it, however many fit
in the window."""


def read(run):
    t = run.spans.mean("multichip.step")
    return None if t is None else 1e3 * t
