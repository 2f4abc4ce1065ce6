"""Device time of cuDNN's channel-padding kernels (names with 'addpadding',
any case: the copy of an input whose channels a tensor-core convolution
cannot take as they are into a padded buffer) per requested frame, in us."""

from benchmarks import readers


def read(records):
    seconds = sum(e - s for name, s, e in records["trace"]["device"]
                  if "addpadding" in name.lower())
    return readers.per_unit(records, seconds, "frames", 1e6)
