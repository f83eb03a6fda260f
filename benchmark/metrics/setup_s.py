"""Set-up seconds: from the process's start to the window's opening
(weights made on the card, the program built and warmed, the traffic
brought to a steady state)."""


def read(run):
    return run.setup_s or None
