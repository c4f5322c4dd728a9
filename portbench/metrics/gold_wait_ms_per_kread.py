"""Milliseconds a thousand reads spent waiting on the gold engine's
workers: the program's `gold.drain` spans (`stats["spans"]`), summed over
the window's calls."""

from portbench.metrics.assemble_ms_per_kread import span_seconds

UNIT = "ms/kread"
LAYER = "gold pool and assembly"
SOURCE = "program_span"
MOVES = "card_ms_per_kread"


def read(run):
    return run.per_kread_ms(span_seconds(run, "gold.drain"))
