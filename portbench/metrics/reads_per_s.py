"""All the reads of all the window's calls over the time from the
window's start to the end of its last call."""

UNIT = "reads/s"
LAYER = "end to end"
SOURCE = "host_clock"
MOVES = None


def read(run):
    return run.reads / run.window_s if run.window_s > 0 else None
