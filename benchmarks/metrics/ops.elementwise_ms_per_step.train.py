"""Device time of elementwise and reduction kernels per train step, in ms."""

from benchmarks import readers


def read(records):
    return readers.kinds_per_unit(records, ("elementwise", "reduction"), "steps", 1e3)
