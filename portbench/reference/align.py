"""One read through the plain reference: its FASTQ record's bases as nt4
codes (io.c:410-515), the D bounds of the read and of its seed, and the
bounded best-first search (the Python branch of align_read_gold,
inexact_match.c:46-66), encoded as its `.aln` record.  Under `-P` the
search starts from the SA intervals of the read's last `precalc_len`
bases (of its reverse complement), which the reference finds by exact
match (exact_match_bounded) where bwbble looks them up in its table of
every k-mer's intervals (precalc_sa_intervals, align.c:174-224)."""

from __future__ import annotations

import numpy as np

from portbench.reference import constants as C
from portbench.reference import gold as G
from portbench.reference.aln import encode_alns
from portbench.reference.fmindex import FMIndex
from portbench.reference.params import AlnParams


def codes_of(record: bytes) -> tuple[np.ndarray, np.ndarray]:
    """(seq, rc) nt4 codes of one FASTQ record's sequence line."""
    lines = record.split(b"\n")
    codes = C.NT4_TABLE[np.frombuffer(lines[1].rstrip(b"\r"),
                                      dtype=np.uint8)]
    return codes, C.NT4_COMPLEMENT[codes[::-1]]


def align_record(idx: FMIndex, record: bytes, params: AlnParams) -> bytes:
    """The `.aln` record bytes of one FASTQ record."""
    seq, rc = codes_of(record)
    n = int(seq.shape[0])
    D = G.calculate_d(idx, seq, n, params)
    if params.seed_length and n > params.seed_length:
        D_seed = G.calculate_d(idx, seq, params.seed_length, params)
    else:
        D_seed = np.zeros((params.seed_length + 1, 2), dtype=np.int64)
    seeds = None
    if params.use_precalc:
        k = int(params.precalc_len)
        tail = rc[n - k:n]
        if (tail > 3).any():                 # read2index's -1: no record
            return encode_alns([])
        seeds = G.exact_match_bounded(idx, tail, k, 0, idx.length - 1,
                                      k - 1, params)
    return encode_alns(G.inexact_match(idx, rc, n, params, D, D_seed,
                                       seeds))
