"""Milliseconds a thousand reads in the entry and formats layer: the
harness's spans around `parse_fastq_bytes` and `write_aln_file`."""

UNIT = "ms/kread"
LAYER = "entry and formats"
SOURCE = "host_clock"
MOVES = "reads_per_s"


def read(run):
    return run.per_kread_ms(sum(c.parse_s + c.write_s for c in run.calls))
