"""Device: the share of the traced window in which no operation ran on
the card."""

from windbench import readers


def read(trace):
    return readers.idle_pct(trace)
