"""p90 of the milliseconds between consecutive chunk deliveries of a
stream, over every gap in the window; a gap still open at the close counts
at its length then where that exceeds every closed gap."""

from benchmark.harness.readers import tail


def read(run):
    if "chunk_gaps_s" not in run.data:
        return None
    v = tail(run.data["chunk_gaps_s"], run.data["open_gaps_s"], 90)
    return None if v is None else 1e3 * v
