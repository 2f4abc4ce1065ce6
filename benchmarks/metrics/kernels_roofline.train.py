"""The program's kernels' byte-bound time over their measured time, in %."""

from benchmarks import readers


def read(records):
    return readers.roofline_pct(records)
