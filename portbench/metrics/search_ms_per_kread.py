"""Milliseconds a thousand reads in the search kernel: the program's
`stats["t_search"]`, the CUDA events that the C launch records right
around each kernel, summed over the window's calls."""

UNIT = "ms/kread"
LAYER = "search"
SOURCE = "program_counter"
MOVES = "reads_per_s"


def read(run):
    return run.per_kread_ms(run.stat_sum("t_search"))
