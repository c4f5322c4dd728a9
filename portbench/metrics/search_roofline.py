"""The search kernel's share of its byte roofline: the least bytes its
launches need (portbench/rooflines/search.py) over the card's memory rate,
over `stats["t_search"]`; nothing on a run without a card.  The reads
counted are those the device finished: in each call, as many as the
call's reads less its `fallback_reads`, and of the records those with the
fewest bytes, so the count is never above what the launches moved."""

import os

from portbench.peaks import H100_HBM_BYTES_S
from portbench.reference.aln import read_records
from portbench.reference.params import AlnParams
from portbench.rooflines import search

UNIT = "%"
LAYER = "kernel"
SOURCE = "program_counter"
MOVES = "reads_per_s"


def read(run):
    t_search = run.stat_sum("t_search")
    if run.device != "cuda" or not t_search:
        return None
    read_len = int(run.traffic["read_len"])
    seed_len = AlnParams().seed_length
    nbytes = 0
    for c in run.calls:
        if not c.ok or c.aln_path is None or not os.path.exists(c.aln_path):
            continue
        with open(c.aln_path, "rb") as f:
            recs = read_records(f.read())
        sizes = sorted(search.record_bytes(lens) for _, _, lens in recs)
        n = max(c.reads - int(c.stats.get("fallback_reads", 0)), 0)
        nbytes += n * search.read_bytes(read_len, seed_len) + sum(sizes[:n])
    return 100.0 * nbytes / H100_HBM_BYTES_S / t_search
