"""Reference-semantics search engine (host gold model).

Frozen copy of bwbble_tpu_torch/gold/engine.py: the benchmark's plain
reference runs it on the `.bwt` and the reads that the program gets.

Every function documents the mg-aligner code it mirrors.  This is a clean
reimplementation from the reference's *behavior* (traced in SURVEY.md), not a
translation of its memory management; data structures are Python lists and
numpy arrays.

Exploration-order parity notes (quirk Q6):
- SA-interval lists are built in (source-interval, base) iteration order with
  adjoining-interval merge against the list tail only (align.c:93-110).
- The search heap pops the LIFO tail of the lowest-score bucket
  (inexact_match.c:594-610); alignments are recorded in pop order.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from portbench.reference import constants as C
from portbench.reference.fmindex import FMIndex
from portbench.reference.params import AlnParams

STATE_M, STATE_I, STATE_D = C.STATE_M, C.STATE_I, C.STATE_D


# --------------------------------------------------------------- SA intervals

def add_sa_interval(intvs: list[list[int]], L: int, U: int) -> None:
    """Append, merging with the tail if adjoining (align.c:93-110)."""
    if intvs and L == intvs[-1][1] + 1:
        intvs[-1][1] = U
    else:
        intvs.append([L, U])


# --------------------------------------------------------------- exact search

def exact_match_bounded(idx: FMIndex, read: np.ndarray, read_len: int,
                        l: int, u: int, i: int, params: AlnParams
                        ) -> list[list[int]]:
    """Backward search of read[0..i] from SA range (l,u)
    (exact_match_bounded, exact_match.c:66-119)."""
    if not params.is_multiref:
        r = _exact_match_1to1_bounded(idx, read, l, u, i)
        return [list(r)] if r is not None else []
    curr: list[list[int]] = [[l, u]]
    for r in range(i, -1, -1):
        c = int(read[r])
        if c == C.NT4_N:
            curr = []
            break
        nxt: list[list[int]] = []
        for L0, U0 in curr:
            for b in range(C.BASES_PER_NUCLEOTIDE):
                base = int(C.NUCL_BASES[c][b])
                L = idx.C_(base) + idx.O(base, L0 - 1) + 1
                U = idx.C_(base) + idx.O(base, U0)
                if L <= U:
                    add_sa_interval(nxt, L, U)
        curr = nxt
        if not curr:
            break
    return curr


def _exact_match_1to1_bounded(idx: FMIndex, read: np.ndarray, l: int, u: int,
                              i: int) -> tuple[int, int] | None:
    """Single-interval backward search on a 4-letter reference
    (exact_match_1to1_bounded, exact_match.c:196-222)."""
    L, U = l, u
    for j in range(i, -1, -1):
        if int(read[j]) > 3:
            return None
        c = int(C.NT4_GRAY[int(read[j])])
        occL = idx.O(c, L - 1)
        occU = occL if (L - 1) == U else idx.O(c, U)
        L = idx.C_(c) + occL + 1
        U = idx.C_(c) + occU
        if L > U:
            return None
    return (L, U)


# ------------------------------------------------------------------- D bounds

def calculate_d(idx: FMIndex, read: np.ndarray, read_len: int,
                params: AlnParams) -> np.ndarray:
    """Lower bound of differences per position (calculate_d,
    inexact_match.c:171-254).  Returns int64 [read_len+1, 2] of
    (num_diff, sa_intv_width)."""
    D = np.zeros((read_len + 1, 2), dtype=np.int64)
    z = 0
    full_L, full_U = 0, idx.length - 1

    if not params.is_multiref:
        L, U = full_L, full_U
        for i in range(read_len - 1, -1, -1):
            c = int(C.NT4_GRAY[int(read[i])])
            if c == C.ORDER_N:
                L, U = full_L, full_U
                z += 1
            else:
                occL = idx.O(c, L - 1)
                occU = occL if (L - 1) == U else idx.O(c, U)
                L = idx.C_(c) + occL + 1
                U = idx.C_(c) + occU
                if L > U:
                    L, U = full_L, full_U
                    z += 1
            D[read_len - 1 - i] = (z, U - L + 1)
        D[read_len] = (z + 1, 0)
        return D

    curr: list[list[int]] = [[full_L, full_U]]
    for i in range(read_len - 1, -1, -1):
        c = int(read[i])
        num_matches = 0
        if c > 3:
            curr = []
        else:
            nxt: list[list[int]] = []
            for L0, U0 in curr:
                for b in range(C.BASES_PER_NUCLEOTIDE):
                    base = int(C.NUCL_BASES[c][b])
                    L = idx.C_(base) + idx.O(base, L0 - 1) + 1
                    U = idx.C_(base) + idx.O(base, U0)
                    if L <= U:
                        num_matches += U - L + 1
                        add_sa_interval(nxt, L, U)
            curr = nxt
        if not curr:
            curr = [[full_L, full_U]]
            z += 1
            num_matches = full_U - full_L + 1
        D[read_len - 1 - i] = (z, num_matches)
    D[read_len] = (z + 1, 0)
    return D


# -------------------------------------------------------------- search arena

@dataclasses.dataclass
class Entry:
    i: int
    L: int
    U: int
    num_mm: int
    num_gapo: int
    num_gape: int
    state: int
    num_snps: int
    score: int
    path: bytes     # states in push order (read-end first)


@dataclasses.dataclass
class Aln:
    score: int
    L: int
    U: int
    num_mm: int
    num_gapo: int
    num_gape: int
    num_snps: int
    aln_length: int
    path: bytes     # push order; zero-extended for exact-completion tails


class Heap:
    """Score-bucketed LIFO heap (inexact_match.c:510-610)."""

    def __init__(self, num_buckets: int):
        self.buckets: list[list[Entry]] = [[] for _ in range(num_buckets)]
        self.best = num_buckets
        self.count = 0

    def push(self, e: Entry) -> None:
        self.buckets[e.score].append(e)
        self.count += 1
        if e.score < self.best:
            self.best = e.score

    def pop(self) -> Entry:
        b = self.buckets[self.best]
        e = b.pop()
        self.count -= 1
        if not b and self.count:
            s = self.best + 1
            while s < len(self.buckets) and not self.buckets[s]:
                s += 1
            self.best = s
        elif self.count == 0:
            self.best = len(self.buckets)
        return e


# ------------------------------------------------------------- inexact search

def inexact_match(idx: FMIndex, read: np.ndarray, read_len: int,
                  params: AlnParams, D: np.ndarray, D_seed: np.ndarray,
                  precalc_intvs: list[list[int]] | None = None) -> list[Aln]:
    """Bounded best-first inexact search (inexact_match, inexact_match.c:256-506).

    `read` is the nt4 reverse complement (the index holds fwd+RC).
    Returns alignments in discovery order (the `.aln` record order).
    """
    p = params
    alns: list[Aln] = []

    count_n = int(np.count_nonzero(read[:read_len] > 3))
    if count_n > p.max_diff:
        return alns

    heap = Heap(p.num_score_buckets)
    if precalc_intvs is not None:
        if not precalc_intvs:
            return alns
        k = p.precalc_len  # PRECALC_INTERVAL_LENGTH (align.h:31)
        for L, U in precalc_intvs:
            heap.push(Entry(i=read_len - k, L=L, U=U, num_mm=0, num_gapo=0,
                            num_gape=0, state=STATE_M, num_snps=0, score=0,
                            path=bytes(k)))
    else:
        heap.push(Entry(i=read_len, L=0, U=idx.length - 1, num_mm=0,
                        num_gapo=0, num_gape=0, state=STATE_M, num_snps=0,
                        score=0, path=b""))

    best_score = p.score(p.max_diff + 1, p.max_gapo + 1, p.max_gape + 1)
    max_diff = p.max_diff
    num_best = 0

    while heap.count != 0:
        if heap.count > p.max_entries:
            break
        e = heap.pop()

        if e.score > best_score + p.mm_score:
            break
        diff_left = max_diff - e.num_mm - e.num_gapo - e.num_gape
        if diff_left < 0:
            continue
        if e.i > 0 and diff_left < D[e.i - 1, 0]:
            continue
        diff_left_seed = p.max_diff_seed - e.num_mm - e.num_gapo - e.num_gape
        seed_index = e.i - (read_len - p.seed_length)
        if seed_index > 0 and diff_left_seed < D_seed[seed_index - 1, 0]:
            continue

        if e.i == 0:
            score = p.score(e.num_mm, e.num_gapo, e.num_gape)
            if not alns:
                best_score = score
                best_diff = e.num_mm + e.num_gapo + e.num_gape
                max_diff = min(best_diff + 1, p.max_diff)
            if score == best_score:
                num_best += e.U - e.L + 1
            elif num_best > p.max_best:
                break
            _add_alignment(alns, e, e.L, e.U, score, len(e.path))
            continue

        if diff_left == 0:
            intvs = exact_match_bounded(idx, read, read_len, e.L, e.U,
                                        e.i - 1, p)
            if intvs:
                score = p.score(e.num_mm, e.num_gapo, e.num_gape)
                if not alns:
                    best_score = score
                    best_diff = e.num_mm + e.num_gapo + e.num_gape
                    max_diff = min(best_diff + 1, p.max_diff)
                if score == best_score:
                    num_best += sum(U - L + 1 for L, U in intvs)
                elif num_best > p.max_best:
                    break
                aln_length = len(e.path) + e.i  # implicit matches (M == 0)
                for L, U in intvs:
                    _add_alignment(alns, e, L, U, score, aln_length)
            continue

        if p.is_multiref:
            Lv = idx.O_alphabet(e.L - 1, inc=1)
            Uv = idx.O_alphabet(e.U, inc=0)
            alphabet_size = 16
        else:
            Lv = idx.O_actg_alphabet(e.L - 1, inc=1)
            Uv = idx.O_actg_alphabet(e.U, inc=0)
            alphabet_size = 5

        allow_diff = allow_indels = allow_mm = True
        allow_open = e.num_gapo < p.max_gapo
        allow_extend = e.num_gape < p.max_gape

        if e.i - 1 > 0:
            if diff_left - 1 < D[e.i - 2, 0]:
                allow_diff = False
            elif (D[e.i - 1, 0] == diff_left - 1 == D[e.i - 2, 0]
                  and D[e.i - 1, 1] == D[e.i - 2, 1]):
                allow_mm = False
        if seed_index - 1 > 0:
            if diff_left_seed - 1 < D_seed[seed_index - 2, 0]:
                allow_diff = False
            elif (D_seed[seed_index - 1, 0] == diff_left_seed - 1
                  == D_seed[seed_index - 2, 0]
                  and D_seed[seed_index - 1, 1] == D_seed[seed_index - 2, 1]):
                allow_mm = False

        tmp = e.num_gapo + e.num_gape
        if (e.i - 1 < p.no_indel_length + tmp
                or (read_len - (e.i - 1)) < p.no_indel_length + tmp):
            allow_indels = False
        if e.num_gapo >= p.max_gapo and e.num_gape >= p.max_gape:
            allow_indels = False

        def push(i, L, U, mm, go, ge, state, snps):
            score = p.score(mm, go, ge)
            heap.push(Entry(i=i, L=L, U=U, num_mm=mm, num_gapo=go,
                            num_gape=ge, state=state, num_snps=snps & 0xFF,
                            score=score,
                            path=e.path + bytes([state])))

        # INDELS (inexact_match.c:434-463)
        if allow_diff and allow_indels:
            if e.state == STATE_I:
                if allow_extend:
                    push(e.i - 1, e.L, e.U, e.num_mm, e.num_gapo,
                         e.num_gape + 1, STATE_I, e.num_snps)
            else:
                if allow_open and e.state == STATE_M:
                    push(e.i - 1, e.L, e.U, e.num_mm, e.num_gapo + 1,
                         e.num_gape, STATE_I, e.num_snps)
                for j in range(1, alphabet_size):
                    if Lv[j] <= Uv[j]:
                        if e.state == STATE_M:
                            if allow_open:
                                push(e.i, int(Lv[j]), int(Uv[j]), e.num_mm,
                                     e.num_gapo + 1, e.num_gape, STATE_D,
                                     e.num_snps)
                        else:
                            if allow_extend:
                                push(e.i, int(Lv[j]), int(Uv[j]), e.num_mm,
                                     e.num_gapo, e.num_gape + 1, STATE_D,
                                     e.num_snps)

        # MATCH / MISMATCH (inexact_match.c:465-504)
        c = int(read[e.i - 1])
        if allow_diff and allow_mm:
            for j in range(1, alphabet_size):
                if Lv[j] <= Uv[j]:
                    if p.is_multiref:
                        is_mm = (c > 3 or j == C.ORDER_N
                                 or (int(C.NT4_GRAY_VAL[c])
                                     & int(C.GRAY_VAL[j])) == 0)
                        snp = int(C.IS_SNP[j])
                    else:
                        is_mm = (c > 3 or c != (j - 1))
                        snp = 0
                    push(e.i - 1, int(Lv[j]), int(Uv[j]),
                         e.num_mm + (1 if is_mm else 0), e.num_gapo,
                         e.num_gape, STATE_M, e.num_snps + snp)
        elif c < 4:
            if p.is_multiref:
                for b in range(C.BASES_PER_NUCLEOTIDE):
                    base = int(C.NUCL_BASES[c][b])
                    if Lv[base] <= Uv[base]:
                        push(e.i - 1, int(Lv[base]), int(Uv[base]), e.num_mm,
                             e.num_gapo, e.num_gape, STATE_M,
                             e.num_snps + int(C.IS_SNP[base]))
            else:
                if Lv[c + 1] <= Uv[c + 1]:
                    push(e.i - 1, int(Lv[c + 1]), int(Uv[c + 1]), e.num_mm,
                         e.num_gapo, e.num_gape, STATE_M, e.num_snps)

    return alns


def _add_alignment(alns: list[Aln], e: Entry, L: int, U: int, score: int,
                   aln_length: int) -> None:
    """Record an alignment, de-duplicating identical (L,U) when gaps are
    involved (add_alignment, align.c:271-298)."""
    if e.num_gapo:
        for a in alns:
            if a.L == L and a.U == U:
                return
    path = e.path
    if aln_length > len(path):
        path = path + bytes(aln_length - len(path))
    alns.append(Aln(score=score, L=L, U=U, num_mm=e.num_mm,
                    num_gapo=e.num_gapo, num_gape=e.num_gape,
                    num_snps=e.num_snps, aln_length=aln_length,
                    path=path[:aln_length]))
