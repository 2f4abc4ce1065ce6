"""Model FLOPs of the window's steps over its seconds and the card's dense peak, in %."""

from benchmarks import readers


def read(records):
    return readers.mfu_pct(records)
