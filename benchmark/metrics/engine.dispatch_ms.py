"""Mean host milliseconds of one `Engine.step_dispatch` (admission, then one
queued decode segment), over the window's dispatches outside the profiled
sub-window. A faster dispatch lowers it, however many fit in the window."""


def read(run):
    t = run.spans.mean("engine.step_dispatch")
    return None if t is None else 1e3 * t
