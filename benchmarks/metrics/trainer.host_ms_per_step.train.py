"""Host time inside Trainer.run's steps per traced train step, in ms: the
union of the program's `trainer.step` spans over the traced steps."""

from benchmarks import readers, spans


def read(records):
    inside = spans.seconds(records["trace"], "trainer.step")
    return None if inside is None else readers.per_unit(records, inside, "steps", 1e3)
