"""Share of the traced window in which no operation ran on the card, in %."""

from benchmarks import readers


def read(records):
    return readers.idle_pct(records)
