"""Share of the traced sub-window in which no operation ran, card by card,
averaged over the cards: 100 x (1 - mean over cards of that card's busy
seconds (the union of its own events' intervals, `drivers/multichip.py`
`CardsTrace`) / the sub-window's unprofiled length). A union over the cards
would count a card idle only while all are."""


def read(run):
    tr = run.trace
    busy = None if tr is None else tr.notes.get("busy_by_card")
    if not busy or not tr.unprofiled_s:
        return None
    return 100.0 * (1.0 - sum(busy) / len(busy) / tr.unprofiled_s)
