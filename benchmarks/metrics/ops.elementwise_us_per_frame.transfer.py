"""Device time of elementwise and reduction kernels per requested frame, in us."""

from benchmarks import readers


def read(records):
    return readers.kinds_per_unit(records, ("elementwise", "reduction"), "frames", 1e6)
