"""Milliseconds a thousand reads in the D bounds: the program's
`stats["t_dbounds"]`, summed over the window's calls."""

UNIT = "ms/kread"
LAYER = "D bounds"
SOURCE = "program_counter"
MOVES = "reads_per_s"


def read(run):
    return run.per_kread_ms(run.stat_sum("t_dbounds"))
