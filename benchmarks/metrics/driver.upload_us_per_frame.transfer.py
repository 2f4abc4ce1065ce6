"""Time spent putting the videos on the card per traced frame, in us: the
union of the program's `transfer.upload` spans over the traced slice's
frames."""

from benchmarks import readers, spans


def read(records):
    inside = spans.seconds(records["trace"], "transfer.upload")
    return None if inside is None else readers.per_unit(records, inside, "frames", 1e6)
