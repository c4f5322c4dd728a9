"""Host alignment pipeline drivers.

`align_reads_gold` runs the full reference-semantics pipeline on the host
(align_reads + align_reads_inexact, align.c:40-87 / inexact_match.c:25-89);
the device pipeline in bwbble_tpu_torch.engine.pipeline produces identical results
with the heavy loops on TPU and falls back to these functions per read on
capacity overflow.
"""

from __future__ import annotations

import numpy as np

from bwbble_tpu_torch.align.eval import finalize_read, pick_hits, resolve_sa_gold
from bwbble_tpu_torch.align.params import AlnParams
from bwbble_tpu_torch.formats.fasta import Annotations
from bwbble_tpu_torch.formats.fastq import Reads
from bwbble_tpu_torch.formats.sam import format_sam_record, write_sam_header
from bwbble_tpu_torch.gold import engine as G
from bwbble_tpu_torch.index.fmindex import FMIndex


_GOLD_TABLES = None


def _gold_tables():
    global _GOLD_TABLES
    if _GOLD_TABLES is None:
        from bwbble_tpu_torch import constants as C
        skipped = np.zeros(16, dtype=np.uint8)
        for j in C.SKIPPED_ORDERS:
            skipped[j] = 1
        _GOLD_TABLES = np.ascontiguousarray(np.concatenate([
            np.asarray(C.NUCL_BASES, dtype=np.uint8).reshape(-1),
            np.asarray(C.GRAY_VAL, dtype=np.uint8),
            np.asarray(C.NT4_GRAY_VAL, dtype=np.uint8),
            np.asarray(C.IS_SNP, dtype=np.uint8),
            skipped]))
    return _GOLD_TABLES


def align_read_gold(idx: FMIndex, seq: np.ndarray, rc: np.ndarray,
                    length: int, params: AlnParams,
                    precalc=None) -> list[G.Aln]:
    """Align one read (the per-read body of align_reads_inexact,
    inexact_match.c:46-66).

    Runs the native gold engine when available (C++ port of the Python
    model below, ~100-500x faster; bwbble_gold_align_multiref); the Python
    model remains the semantic reference and handles -S single-genome
    mode, -P seeding, and native capacity overflow."""
    if params.use_precalc:
        ri = G.read2index(rc, length, k=params.precalc_len)
        if ri < 0:
            return []
        precalc_intvs = precalc[ri]
    else:
        precalc_intvs = None

    if (precalc_intvs is None and params.is_multiref and 0 < length <= 255):
        from bwbble_tpu_torch.native import get_native
        nat = get_native()
        if nat is not None and getattr(nat, "_has_gold", False):
            from bwbble_tpu_torch import constants as C
            pp = np.array([
                params.mm_score, params.gapo_score, params.gape_score,
                params.max_diff, params.max_gapo, params.max_gape,
                params.seed_length, params.max_diff_seed, params.max_best,
                params.no_indel_length, params.max_entries,
                params.num_score_buckets], dtype=np.int64)
            out = nat.gold_align_multiref(
                idx.bit_planes(), idx.occ, idx.Carr, idx.length, idx.sa0,
                C.OCC_INTERVAL, _gold_tables(), pp, seq, rc, length,
                fused=idx.fused_planes())
            if out is not None:
                meta, paths = out
                return [G.Aln(score=int(m[0]), L=int(m[1]), U=int(m[2]),
                              num_mm=int(m[3]), num_gapo=int(m[4]),
                              num_gape=int(m[5]), num_snps=int(m[6]),
                              aln_length=int(m[7]),
                              path=bytes(paths[t, :int(m[7])]))
                        for t, m in enumerate(meta)]

    D = G.calculate_d(idx, seq, length, params)
    if params.seed_length and length > params.seed_length:
        D_seed = G.calculate_d(idx, seq, params.seed_length, params)
    else:
        D_seed = np.zeros((params.seed_length + 1, 2), dtype=np.int64)
    return G.inexact_match(idx, rc, length, params, D, D_seed, precalc_intvs)


def align_reads_gold(idx: FMIndex, reads: Reads, params: AlnParams,
                     precalc=None) -> list[list[G.Aln]]:
    return [
        align_read_gold(idx, reads.seq[i], reads.rc[i], int(reads.lengths[i]),
                        params, precalc)
        for i in range(reads.count)
    ]


def alns_to_sam(idx: FMIndex, ann: Annotations, reads: Reads,
                per_read_alns, max_diff: int = 6,
                sa_resolver=None) -> str:
    """Evaluate alignments and render SAM text (alns2sam, align.c:494-556).

    `per_read_alns` entries must carry disk-order paths (as returned by
    formats.aln.read_aln_file).  `sa_resolver(rows)->positions` defaults to
    the host gold resolver; the device pipeline passes a batched TPU kernel.
    """
    hits = [pick_hits(a) for a in per_read_alns]
    mapped = [k for k, h in enumerate(hits) if h.aln_type != 0]
    rows = np.array([hits[k].aln_sa for k in mapped], dtype=np.int64)
    if sa_resolver is None:
        positions = resolve_sa_gold(idx, rows)
    else:
        positions = np.asarray(sa_resolver(rows), dtype=np.int64)
    for k, pos in zip(mapped, positions):
        finalize_read(hits[k], int(pos), idx.length, max_diff)

    import io
    out = io.StringIO()
    write_sam_header(out, ann)
    n = min(reads.count, len(per_read_alns))
    for k in range(n):
        out.write(format_sam_record(
            reads.names[k], reads.seq[k], reads.rc[k], reads.qual[k],
            int(reads.lengths[k]), hits[k], ann))
    return out.getvalue()
