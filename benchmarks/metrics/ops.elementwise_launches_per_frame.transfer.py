"""Launches of elementwise and reduction kernels per requested frame: the
count of the traced slice's device operations of those kinds
(`benchmarks/kernels.py`) over its frames."""

from benchmarks import kernels, readers


def read(records):
    launches = sum(1 for name, _, _ in records["trace"]["device"]
                   if kernels.kind_of(name) in ("elementwise", "reduction"))
    return readers.per_unit(records, launches, "frames", 1.0)
