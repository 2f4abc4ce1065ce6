"""Model FLOPs of the window's videos over its seconds and the card's dense peak, in %."""

from benchmarks import readers


def read(records):
    return readers.mfu_pct(records)
