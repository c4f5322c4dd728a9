"""Milliseconds a thousand reads on the host outside the D bounds and the
search: `stats["t_host"]` (the gold pool's drain and the assembly of the
records), summed over the window's calls."""

UNIT = "ms/kread"
LAYER = "gold pool and assembly"
SOURCE = "program_counter"
MOVES = "reads_per_s"


def read(run):
    return run.per_kread_ms(run.stat_sum("t_host"))
