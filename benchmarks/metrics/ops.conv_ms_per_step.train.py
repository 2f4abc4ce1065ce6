"""Device time of convolution kernels per train step, in ms."""

from benchmarks import readers


def read(records):
    return readers.kinds_per_unit(records, ("convolution",), "steps", 1e3)
