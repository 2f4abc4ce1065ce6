"""Host time spent copying the answer out of the engine's staging slots per
traced frame, in us: the union of the program's `transfer.deliver` spans
over the traced slice's frames."""

from benchmarks import readers, spans


def read(records):
    inside = spans.seconds(records["trace"], "transfer.deliver")
    return None if inside is None else readers.per_unit(records, inside, "frames", 1e6)
