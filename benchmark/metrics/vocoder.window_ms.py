"""Mean milliseconds of one vocoder window (codec decode of the window,
watermark and overlap-add, `last_stats["chunk_s"]`), over the window's
vocoder windows outside the profiled sub-window."""


def read(run):
    v = run.data.get("chunk_s")
    return 1e3 * sum(v) / len(v) if v else None
