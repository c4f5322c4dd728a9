"""Seconds from the start of the process to the end of the warm-up call:
imports, the world (built once a checkout), the reads, the index onto the
card, and one call at the cell's shapes."""

UNIT = "s"
LAYER = "end to end"
SOURCE = "host_clock"
MOVES = None


def read(run):
    return run.setup_s
