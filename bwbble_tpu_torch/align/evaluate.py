"""Simulation-truth alignment evaluator (eval_alns, align.c:655-722).

Classifies every read against the ground truth encoded in its name
(parse_read_mapping, io.c:529-562) and writes the reference's four binary
id files — bwbble.{unaligned,conf,corr,mis} — each a list of int32 read ids
followed by a trailing int32 count.  This doubles as the end-to-end accuracy
harness for regression tests (SURVEY.md §4).
"""

from __future__ import annotations

import os

import numpy as np

from bwbble_tpu_torch.align.eval import (
    ALN_NOMATCH, MAPQ_CONFIDENT, check_ref_mapping, finalize_read, pick_hits,
    resolve_sa_gold,
)
from bwbble_tpu_torch.formats.fastq import Reads, parse_read_mapping
from bwbble_tpu_torch.index.fmindex import FMIndex


def eval_alns(idx: FMIndex, reads: Reads, per_read_alns,
              is_multiref: bool = True, max_diff: int = 6,
              out_dir: str = ".", sa_resolver=None) -> dict:
    """Evaluate alignments; returns the summary counters and writes the four
    id files under `out_dir`."""
    hits = [pick_hits(a) for a in per_read_alns]
    mapped = [k for k, h in enumerate(hits) if h.aln_type != ALN_NOMATCH]
    rows = np.array([hits[k].aln_sa for k in mapped], dtype=np.int64)
    if sa_resolver is None:
        positions = resolve_sa_gold(idx, rows)
    else:
        positions = np.asarray(sa_resolver(rows), dtype=np.int64)
    for k, pos in zip(mapped, positions):
        finalize_read(hits[k], int(pos), idx.length, max_diff)

    cats = {"unaligned": [], "conf": [], "corr": [], "mis": []}
    for i in range(min(reads.count, len(hits))):
        h = hits[i]
        if h.aln_type == ALN_NOMATCH:
            cats["unaligned"].append(i)
            continue
        if h.mapq < MAPQ_CONFIDENT:
            continue
        cats["conf"].append(i)
        truth = parse_read_mapping(reads.names[i])
        if check_ref_mapping(h, truth, is_multiref):
            cats["corr"].append(i)
        else:
            cats["mis"].append(i)

    for name, ids in cats.items():
        with open(os.path.join(out_dir, f"bwbble.{name}"), "wb") as f:
            arr = np.array(ids + [len(ids)], dtype="<i4")
            f.write(arr.tobytes())

    summary = dict(total=reads.count, confident=len(cats["conf"]),
                   correct=len(cats["corr"]), misaligned=len(cats["mis"]),
                   unaligned=len(cats["unaligned"]))
    print(f"total num_reads = {summary['total']}, confident = "
          f"{summary['confident']} correct = {summary['correct']}, "
          f"misaligned = {summary['misaligned']}, unaligned = "
          f"{summary['unaligned']}")
    return summary
