"""The comparison that decides `correct`: after the window, a sample of
the window's reads, drawn from the seed, is run through the plain
reference (`portbench/reference`) in spawned worker processes, and each
read's `.aln` record, as the program wrote it, is held against the
reference's, byte for byte.  A read of a call that raised, or that has no
record in its call's file, is unanswered.  Both counts have the limit 0:
the program's `.aln` is byte-identical to the reference's by design."""

from __future__ import annotations

import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor

import numpy as np

_IDX = None
_PARAMS = None


def _init(bwt: str, params: dict) -> None:
    global _IDX, _PARAMS
    from portbench.reference.fmindex import FMIndex
    from portbench.reference.params import AlnParams
    _IDX = FMIndex.load(bwt)
    _PARAMS = AlnParams(**params)


def _align(record: bytes) -> bytes:
    from portbench.reference.align import align_record
    return align_record(_IDX, record, _PARAMS)


def reference_params(config: dict, **override) -> dict:
    """AlnParams fields of the reference for a configuration: those the
    program is given (the reference's AlnParams has the same fields)."""
    return dict(config["align"]["params"], **override)


def reference_records(bwt: str, params: dict, records: list[bytes],
                      workers: int) -> list[bytes]:
    """The reference's `.aln` record of each FASTQ record, in order."""
    if not records:
        return []
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=max(1, min(workers, len(records))),
                             mp_context=ctx, initializer=_init,
                             initargs=(bwt, params)) as ex:
        return list(ex.map(_align, records, chunksize=1))


def sample(seed: int, n_calls: int, reads_per_call: int, n: int
           ) -> list[tuple[int, int]]:
    """(call of the window, read of the call) pairs, drawn from `seed`
    without repeats; every read when the window holds `n` or fewer."""
    from portbench.gen.reads import rng_of
    total = n_calls * reads_per_call
    if total <= n:
        picks = np.arange(total)
    else:
        picks = np.sort(rng_of(seed, 2).choice(total, size=n, replace=False))
    return [(int(p // reads_per_call), int(p % reads_per_call))
            for p in picks]


def program_records(aln_path: str | None, reads: int) -> list:
    """The program's record bytes of each read of one call (None where a
    read has none)."""
    from portbench.reference.aln import read_records
    if aln_path is None or not os.path.exists(aln_path):
        return [None] * reads
    with open(aln_path, "rb") as f:
        data = f.read()
    try:
        recs = read_records(data)
    except ValueError:
        return [None] * reads
    out = [data[o:o + n] for o, n, _ in recs[:reads]]
    return out + [None] * (reads - len(out))
