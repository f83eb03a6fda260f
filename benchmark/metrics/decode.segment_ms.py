"""Mean milliseconds of one decode segment of the decode runtime (to its
tokens read on the host, `last_stats["segment_s"]`), over the window's
segments outside the profiled sub-window."""


def read(run):
    v = run.data.get("segment_s")
    return 1e3 * sum(v) / len(v) if v else None
