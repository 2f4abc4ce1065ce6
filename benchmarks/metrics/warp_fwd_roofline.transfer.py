"""The warp_fwd operation's byte-bound time over its kernels' measured time, in %."""

from benchmarks import readers


def read(records):
    return readers.roofline_pct(records, ("warp_fwd",))
