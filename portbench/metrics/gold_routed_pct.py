"""Share of the window's reads that the device did not finish and the
host gold engine aligned: `stats["fallback_reads"]` over the reads."""

UNIT = "%"
LAYER = "routing"
SOURCE = "program_counter"
MOVES = "reads_per_s"


def read(run):
    n = run.stat_sum("fallback_reads")
    if n is None or run.reads == 0:
        return None
    return 100.0 * n / run.reads
