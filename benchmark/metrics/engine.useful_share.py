"""Useful tokens delivered over the token slots dispatched (segment steps x
slots), over the window (`Engine.stats`)."""


def read(run):
    d = run.data.get("dispatched_token_slots")
    return None if not d else 100.0 * run.data["useful_tokens"] / d
