"""Alignment evaluation: MAPQ, strand/position resolution, SAM records.

Mirrors eval_aln / mapq (align.c:738-812) and print_aln2sam
(align.c:562-652).  Structured in two phases so the suffix-array resolution
(the only index-dependent step) can be batched onto the device:

1. `pick_hits`    — per read, select the first best alignment, accumulate
                    top1/top2 interval widths, emit the SA row to resolve.
2. `finalize_read`— given ref_pos = SA(row), derive strand/position/MAPQ.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from bwbble_tpu_torch import constants as C
from bwbble_tpu_torch.gold.engine import Aln

ALN_NOMATCH, ALN_UNIQUE, ALN_REPEAT = 0, 1, 2   # align.h:24-26
MAPQ_CONFIDENT = 10                              # align.h:28


@dataclasses.dataclass
class ReadHit:
    aln_type: int = ALN_NOMATCH
    top1: int = 0
    top2: int = 0
    num_mm: int = 0
    num_gapo: int = 0
    num_gape: int = 0
    aln_score: int = 0
    aln_length: int = 0
    path: bytes = b""       # disk-order path (reversed search path)
    aln_sa: int = 0
    # filled by finalize_read:
    aln_strand: int = 0
    aln_pos: int = 0
    mapq: int = 0


def pick_hits(alns: list[Aln]) -> ReadHit:
    """Phase 1 of eval_aln (align.c:760-801 minus the SA call)."""
    hit = ReadHit()
    if not alns:
        return hit
    best_score = alns[0].score
    for k, a in enumerate(alns):
        width = a.U - a.L + 1
        if a.score > best_score:
            hit.top2 += width
        else:
            hit.top1 += width
            if k == 0:
                hit.num_mm = a.num_mm
                hit.num_gapo = a.num_gapo
                hit.num_gape = a.num_gape
                hit.aln_score = a.score
                hit.aln_length = a.aln_length
                hit.path = a.path
                hit.aln_sa = a.L
    hit.aln_type = ALN_REPEAT if hit.top1 > 1 else ALN_UNIQUE
    return hit


def aln_ref_length(path: bytes) -> int:
    """Path length minus insertions (get_aln_length, align.c:748-757)."""
    return len(path) - path.count(bytes([C.STATE_I]))


def finalize_read(hit: ReadHit, ref_pos: int, bwt_length: int, max_mm: int
                  ) -> None:
    """Phase 2: strand/pos from the resolved SA value (align.c:788-799) and
    MAPQ (align.c:738-746)."""
    if hit.aln_type == ALN_NOMATCH:
        return
    if ref_pos > (bwt_length - 1) // 2:
        # hit lies in the appended reverse complement => forward strand
        hit.aln_strand = 0
        fwd_pos = (bwt_length - 1) - ref_pos - 1
        hit.aln_pos = fwd_pos - aln_ref_length(hit.path) + 1
    else:
        hit.aln_strand = 1
        hit.aln_pos = ref_pos
    hit.mapq = mapq(hit, max_mm)


def mapq(hit: ReadHit, max_mm: int) -> int:
    """BWA-style single-end mapping quality (mapq, align.c:738-746)."""
    if hit.top1 == 0:
        return 23
    if hit.top1 > 1:
        return 0
    if hit.num_mm == max_mm:
        return 25
    if hit.top2 == 0:
        return 37
    n = min(hit.top2, 255)
    q = int(4.343 * math.log(n) + 0.5)
    return 0 if q > 23 else 23 - q


def check_ref_mapping(hit: ReadHit, truth: dict, is_multiref: bool) -> bool:
    """Simulation-truth check (check_ref_mapping, align.c:815-835)."""
    if bool(hit.aln_strand) != bool(truth["strand"]):
        return False
    if is_multiref:
        return any(hit.aln_pos == m - 1 for m in truth["mref_pos"])
    return (truth["ref_pos_l"] - 1 <= hit.aln_pos <= truth["ref_pos_r"] - 1)


def resolve_sa_gold(idx, rows: np.ndarray) -> np.ndarray:
    """Host SA resolution for a batch of rows (SA, bwt.c:320-329)."""
    return np.array([idx.SA(int(r)) for r in rows], dtype=np.int64)
