"""Useful speech tokens that the window's collects delivered, over the
window's seconds (from the collect that opened it to the one that closed
it). 50 tokens are 1 s of audio."""


def read(run):
    n = run.data.get("useful_tokens")
    if n is None or not run.window_s:
        return None
    return n / run.window_s
