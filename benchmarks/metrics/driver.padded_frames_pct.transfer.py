"""Share of the generator's frames that were bucket padding, in %: counted
over the window by a forward hook the benchmark sets on the program's
generator."""


def read(records):
    if not records.get("generator_frames"):
        return None
    return 100.0 * records["padded_frames"] / records["generator_frames"]
