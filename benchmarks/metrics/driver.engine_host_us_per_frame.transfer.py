"""Host time inside TransferEngine calls per traced frame, in us: the union
of the program's `transfer.video` spans over the traced slice's frames."""

from benchmarks import readers, spans


def read(records):
    inside = spans.seconds(records["trace"], "transfer.video")
    return None if inside is None else readers.per_unit(records, inside, "frames", 1e6)
