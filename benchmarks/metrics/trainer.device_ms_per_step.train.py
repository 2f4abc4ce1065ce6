"""Busy device time of the traced dispatches per train step, in ms."""

from benchmarks import readers


def read(records):
    return readers.busy_ms_per_step(records)
