"""Device time of convolution kernels per requested frame, in us."""

from benchmarks import readers


def read(records):
    return readers.kinds_per_unit(records, ("convolution",), "frames", 1e6)
