"""Inexact search: the plain PyTorch version and the public entry points
`inexact_search` (fixed batch: one lane per read) and
`inexact_search_queued` (ring queue: lanes stream reads).

Counterpart of bwbble_tpu/engine/inexact.py.  The search is the reference's
score-bucketed best-first DFS (inexact_match.c:256-506):

- **Dense frames.**  Every pop reserves one frame of NSLOT candidate rows in
  the lane's arena; slot s of the frame holds expansion candidate s (slot 0
  the insertion, 1..NC the deletions, NC+1..2NC the match/mismatch pushes
  over the alphabet: the NC = 11 non-skipped IUPAC codes of a multi-genome,
  or the NC = 4 pure bases of a single genome, `-S`).  Node ids are
  NROOT + frame * NSLOT + slot, so a node's appended path state is a static
  function of its slot and only the parent id is stored per frame.
- **Score-bucket stacks.**  The reference heap (score buckets, LIFO within a
  bucket, pop = tail of the best bucket) is per-lane bucket heads plus a
  per-node `prev` link.  Exploration order is bit-identical.
- **Packed node words.**  A node is NW = 4 int32s: L, U, meta1
  (i|mm|go|ge|state|plen), meta2 (snps | prev+1 << 8).  On the int64
  whole-genome layout (`didx.idt` int64) L and U take two words each, low
  word first: NW = 6, and the frame rows widen to hold NSLOT * 6 words.
  As in the JAX package, the int64 layout runs fixed batches only: the
  queued search refuses it.
- **Seeded roots (`-P`).**  Without seeds a read has one root, the whole
  SA range at i = len (NROOT = 1).  With a seed table, a read's root rows
  are its first S = NROOT interval(s) of the table entry of its last
  PK = precalc_len bases: root s < scnt is (L_s, U_s) at i = len - PK with
  a PK-long all-match path, linked to root s - 1 in bucket 0, so the roots
  pop last-first as the reference's heap pops its pushes
  (inexact_match.c:269-282).  A read with scnt == 0 (no seed hit) is done
  with no alignment and no overflow.  Root pops take frames like any other
  pop.
- **Per-read frame budget.**  A read may make NFRAME = (cap - NROOT) //
  NSLOT - 1 pops of its own.  Exact-completion characters and emissions
  cost no budget, so results do not depend on which lane serves a read,
  when, or what else is in the batch.  The two launch modes differ in when
  the budget binds.  *Ring*: a read that is not finished right after its
  NFRAME-th pop is flagged overflow, before it looks whether its heap is
  empty and before an exact completion that the pop started.  *Fixed*: a
  read is flagged when it attempts one more pop (its heap is not empty and
  the popped node is not past the stop score) after NFRAME pops, so a read
  whose NFRAME-th pop finishes it is a finished read.
- **Exact completion** (inexact_match.c:345-375) runs over interval lists of
  capacity `xcap` (or `kx` when xcap == 0) with add_sa_interval merging; a
  list that would exceed the capacity flags overflow.  A single genome
  keeps one interval (exact_match_1to1_bounded).

Any capacity overflow (frame budget, interval list, ACAP, path length,
max_iters work units) ends the read at once with its flag set: callers
discard and retry such reads, so their other outputs are reported as zero.

On CUDA tensors both entry points launch the hand-written kernel
(engine/kernel.py, csrc/ring_search.cu); the plain version here serves CPU
tensors, the tests, and the on-card comparison against the kernel.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from bwbble_tpu_torch import constants as C
from bwbble_tpu_torch.align.params import AlnParams
from bwbble_tpu_torch.engine import index_device
from bwbble_tpu_torch.engine.device_index import DeviceIndex
from bwbble_tpu_torch.engine.intervals import expand_step
from bwbble_tpu_torch.engine.rank import (rank1_pair, rank_actg_dfs_pair,
                                          rank_all_dfs_pair)

MODE_DFS, MODE_EXACT, MODE_DONE = 0, 1, 2

_MATCH = np.asarray(C.MATCH_MATRIX, dtype=np.int32)       # [5, 16]
_IS_SNP = np.asarray(C.IS_SNP, dtype=np.int32)
_GRAY4 = np.asarray(C.NT4_GRAY, dtype=np.int32)

# meta1 bit layout: i(8) | mm(5) | go(3) | ge(4) | st(2) | plen(9)
_SH_MM, _SH_GO, _SH_GE, _SH_ST, _SH_PLEN = 8, 13, 16, 20, 22

NB_MAX = 1024         # score buckets of the device engine's domain
# q_meta columns; META_OVER holds the reason bits below (0 = no overflow)
(META_NALN, META_OVER, META_LANE, META_WORK, META_RANK, META_FRD, META_FWR,
 META_POPS, META_ROOT) = range(9)
NMETA = 9
# overflow reasons: interval list, ACAP, path length, frame budget, max_iters
OV_LIST, OV_ACAP, OV_PATH, OV_FRAMES, OV_WORK = 1, 2, 4, 8, 16


def alphabet(multiref: bool) -> tuple[int, ...]:
    """The codes a node expands over, in slot order: the 11 non-skipped
    IUPAC codes of a multi-genome, or the Gray codes of the four pure bases
    A, G, C, T of a single genome."""
    if multiref:
        return tuple(j for j in range(1, 16) if j not in C.SKIPPED_ORDERS)
    return tuple(int(j) for j in C.NT4_GRAY[:4])


# the JAX package's refusal of a queued search on the int64 layout
QUEUED_I64 = ("queue mode packs node words through int32 slabs; use fixed "
              "batching (queued=False) with an int64 index")


def row_words(multiref: bool, x64: bool = False) -> int:
    """int32 words of a frame row: NSLOT * NW + 1 (the parent id), padded
    to a multiple of 4 words so rows stay 16-byte aligned: 128 words (512
    bytes) for NSLOT = 23, 40 words (160 bytes) for NSLOT = 9; on the int64
    layout (NW = 6) 140 and 56 words."""
    if x64:
        return 140 if multiref else 56
    return 128 if multiref else 40


def _pack1(i, mm, go, ge, st, plen):
    return (i | (mm << _SH_MM) | (go << _SH_GO) | (ge << _SH_GE)
            | (st << _SH_ST) | (plen << _SH_PLEN))


def _unpack1(m):
    return (m & 0xFF, (m >> _SH_MM) & 0x1F, (m >> _SH_GO) & 0x7,
            (m >> _SH_GE) & 0xF, (m >> _SH_ST) & 0x3, (m >> _SH_PLEN) & 0x1FF)


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Capacities of one search launch.

    `max_iters` bounds ONE READ's work units (its pops plus its exact-
    completion characters), in both launch modes: a read that would start
    one more unit after `max_iters` of its own is flagged overflow.  The JAX
    package's field of the same name bounds the lockstep waves of a whole
    launch and flags every lane still alive at the end; the port's lanes do
    not wait for each other, so the per-read rule is the only one it has.
    A read the JAX launch finishes within `max_iters` waves has made at
    most that many work units, so the port finishes it too.

    The JAX class also has `flush`, `xsteps`, `exit_alive` and `backend`.
    All four steer the lockstep schedule of that package's launches and
    change no per-read result; the port has no such schedule and no such
    fields."""
    cap: int = 32768          # arena rows per lane (bounds a read's pops)
    acap: int = 24            # reported alignments per read
    kx: int = 4               # exact-completion list capacity when xcap == 0
    max_iters: int = 200_000  # bound on one read's work units
    pathcap: int = 0          # reported path length bound (0 => Lmax + 32)
    xcap: int = 0             # exact-completion interval-list capacity


@dataclasses.dataclass(frozen=True)
class RingStatics:
    """Sizes derived from (params, cfg, shapes), shared by the kernel
    wrapper and the plain version."""
    multiref: bool
    fixed: bool               # fixed-batch frame-budget rule (else ring)
    x64: bool                 # int64 index layout: L and U take 2 words
    NW: int                   # int32 words a node: 4, or 6 when x64
    NC: int
    NSLOT: int
    ROWW: int
    NB: int
    NFRAME: int
    ACAP: int
    XC: int
    PATHCAP: int
    PW: int
    max_iters: int
    Lmax: int
    DS: int
    seeded: bool              # root rows come from seed intervals (-P)
    NROOT: int                # root rows per read (seed slots, or 1)
    PK: int                   # seed length: a seeded root's i = len - PK


def ring_statics(params: AlnParams, cfg: EngineConfig, Lmax: int,
                 DS: int, fixed: bool = False, seed_slots: int = 0,
                 x64: bool = False) -> RingStatics:
    """`seed_slots` > 0: a seeded search with that many root rows a read
    (NROOT) and seeds of params.precalc_len bases; 0: one unseeded root.
    `x64`: the int64 index layout, which runs fixed batches only."""
    if x64 and not fixed:
        raise NotImplementedError(QUEUED_I64)
    p = params
    seeded = int(seed_slots) > 0
    NROOT = int(seed_slots) if seeded else 1
    PK = int(p.precalc_len) if seeded else 0
    multiref = bool(p.is_multiref)
    NC = len(alphabet(multiref))
    NSLOT = 1 + 2 * NC
    if not (p.max_diff + 1 <= 31 and p.max_gapo + 1 <= 7
            and p.max_gape + 1 <= 15):
        raise ValueError("alignment parameters exceed the packed node word")
    pathcap = int(cfg.pathcap) or (Lmax + 32)
    if Lmax > 255 or pathcap > 511:
        raise ValueError("reads longer than 255 or paths longer than 511")
    cap = int(cfg.cap)
    if (cap - NROOT) // NSLOT < 2:
        raise ValueError(f"cfg.cap={cap} too small: need >= "
                         f"{NROOT + 2 * NSLOT} rows")
    nframe = (cap - NROOT) // NSLOT - 1
    # prev links pack as (node + 1) << 8 into meta2's upper 24 bits; a lane
    # restarts its pop clock at every read, so ids stay below this
    if NROOT + (nframe + 1) * NSLOT >= (1 << 24):
        raise ValueError("cfg.cap too large for 24-bit packed prev links")
    nb = ((p.max_diff + 1) * p.mm_score + (p.max_gapo + 1) * p.gapo_score
          + (p.max_gape + 1) * p.gape_score)
    if not 0 < nb <= NB_MAX:
        raise ValueError(f"{nb} score buckets: the search holds 1..{NB_MAX}")
    xc = int(cfg.xcap) if int(cfg.xcap) > 0 else int(cfg.kx)
    return RingStatics(multiref=multiref, fixed=bool(fixed),
                       x64=bool(x64), NW=6 if x64 else 4, NC=NC,
                       NSLOT=NSLOT, ROWW=row_words(multiref, x64), NB=int(nb),
                       NFRAME=nframe, ACAP=int(cfg.acap), XC=xc,
                       PATHCAP=pathcap, PW=(pathcap + 3) // 4,
                       max_iters=int(cfg.max_iters), Lmax=int(Lmax),
                       DS=int(DS), seeded=seeded, NROOT=NROOT, PK=PK)


def slot_states(nc: int) -> np.ndarray:
    """State appended by each candidate slot: [I, D*nc, M*nc]."""
    return np.array([C.STATE_I] + [C.STATE_D] * nc + [C.STATE_M] * nc,
                    dtype=np.int8)


def pack_paths(paths: torch.Tensor) -> torch.Tensor:
    """[..., PC] int8 state walks (values 0..3) -> [..., ceil(PC/4)] uint8,
    2 bits per state (`unpack_paths` restores them host-side)."""
    pc = paths.shape[-1]
    pad = (-pc) % 4
    if pad:
        paths = torch.nn.functional.pad(paths, (0, pad))
    g = paths.reshape(paths.shape[:-1] + ((pc + pad) // 4, 4)).to(torch.int32)
    packed = (g[..., 0] | (g[..., 1] << 2) | (g[..., 2] << 4)
              | (g[..., 3] << 6))
    return packed.to(torch.uint8)


def unpack_paths(packed: np.ndarray, pathcap: int) -> np.ndarray:
    """Host-side inverse of pack_paths (vectorized numpy)."""
    out = np.zeros(packed.shape[:-1] + (packed.shape[-1] * 4,),
                   dtype=np.int8)
    for i in range(4):
        out[..., i::4] = (packed >> (2 * i)) & 3
    return out[..., :pathcap]


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 with two's-complement wrap."""
    return (((x + 2**31) % 2**32) - 2**31).to(torch.int32)


def _join64(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """An int64 from its low and high int32 words."""
    return (hi.to(torch.int64) << 32) | (lo.to(torch.int64) & 0xFFFFFFFF)


def alloc_outputs(Q: int, S: RingStatics, device):
    """Zeroed per-read result slabs: q_alns [Q, 7, ACAP] =
    (L, U, score, len, node, m1, snp), int64 on the int64 layout, else
    int32; q_meta [Q, NMETA] (META_* columns); q_paths [Q, ACAP, PW] 2-bit
    packed reverse-order state walks."""
    adt = torch.int64 if S.x64 else torch.int32
    return (torch.zeros((Q, 7, S.ACAP), dtype=adt, device=device),
            torch.zeros((Q, NMETA), dtype=torch.int32, device=device),
            torch.zeros((Q, S.ACAP, S.PW), dtype=torch.uint8, device=device))


def result_dict(q_alns, q_meta, q_paths):
    """The per-read result dict of inexact_search_queued.  Outputs of
    overflowed reads are zeroed (only their flag and counters mean
    anything)."""
    ovwhy = q_meta[:, META_OVER]
    over = ovwhy > 0
    keep = (~over).to(torch.int32)
    qa = q_alns * keep[:, None, None].to(q_alns.dtype)
    col = [qa[:, j].to(torch.int32) for j in range(2, 7)]
    m1o = col[3]
    return dict(
        n_alns=q_meta[:, META_NALN] * keep,
        o_L=qa[:, 0], o_U=qa[:, 1], o_score=col[0], o_len=col[1],
        o_node=col[2], o_lane=q_meta[:, META_LANE],
        o_mm=(m1o >> _SH_MM) & 0x1F,
        o_go=(m1o >> _SH_GO) & 0x7,
        o_ge=(m1o >> _SH_GE) & 0xF,
        o_snp=col[4],
        o_plen=(m1o >> _SH_PLEN) & 0x1FF,
        overflow=over, ovwhy=ovwhy,
        paths=q_paths * keep.to(torch.uint8)[:, None, None],
        # per-read counters: work units (pops + exact chars), index-table
        # rank rows read, frame rows read (pops + path walk) and written,
        # seed root rows read (root pops of a seeded search)
        n_work=q_meta[:, META_WORK], rank_rows=q_meta[:, META_RANK],
        frame_rd=q_meta[:, META_FRD], frame_wr=q_meta[:, META_FWR],
        pops=q_meta[:, META_POPS], root_rd=q_meta[:, META_ROOT],
    )


# --------------------------------------------------------------------------
# the plain PyTorch version
# --------------------------------------------------------------------------

def _plain_chunk(didx: DeviceIndex, rc, lengths, D, Ds, params: AlnParams,
                 S: RingStatics, q_alns, q_meta, q_paths, seeds=None):
    """Run one chunk of reads, one lane per read, in lockstep to completion;
    fills the chunk's rows of the result slabs and returns the chunk's arena
    [B, NFRAME, ROWW] (frame rows: NSLOT slots of NW words, then the
    parent id).  Serves both launch modes (S.fixed), both alphabets
    (S.multiref), seeded roots (S.seeded: `seeds` = (seed_L, seed_U,
    seed_cnt)) and both index layouts (S.x64: intervals, D bounds and the
    reported L/U in int64)."""
    dev = rc.device
    B, Lmax = rc.shape
    LEN = int(didx.length)
    I32 = torch.int32
    IDT = torch.int64 if S.x64 else I32
    NW = S.NW
    p = params
    p_mm, p_go, p_ge = int(p.mm_score), int(p.gapo_score), int(p.gape_score)
    p_maxdiff, p_maxgapo = int(p.max_diff), int(p.max_gapo)
    p_maxgape, p_seedlen = int(p.max_gape), int(p.seed_length)
    p_maxdiffseed, p_maxbest = int(p.max_diff_seed), int(p.max_best)
    p_noindel, p_maxentries = int(p.no_indel_length), int(p.max_entries)
    NB, NFRAME, ACAP, XC, PATHCAP = S.NB, S.NFRAME, S.ACAP, S.XC, S.PATHCAP
    NC, NSLOT, ROWW = S.NC, S.NSLOT, S.ROWW
    NROOT, PK = S.NROOT, S.PK
    PAR = NSLOT * NW                   # frame-row word holding the parent id
    chars = alphabet(S.multiref)

    def zi():
        return torch.zeros((B,), dtype=I32, device=dev)

    rc = rc.to(I32)
    lengths = lengths.to(I32)
    D = D.to(IDT)
    Ds = Ds.to(IDT)
    arena = torch.zeros((B, NFRAME * ROWW), dtype=I32, device=dev)
    head = torch.full((B, NB), -1, dtype=I32, device=dev)
    if S.seeded:
        # root rows s < scnt, chained last-first in bucket 0 (read_init);
        # a count above NROOT counts as NROOT
        sL, sU = seeds[0].to(IDT), seeds[1].to(IDT)
        scnt = seeds[2].to(I32).clamp(0, NROOT)
        head[:, 0] = scnt - 1
        n_open = scnt.clone()
    else:
        head[:, 0] = 0                 # the root node
        n_open = torch.ones((B,), dtype=I32, device=dev)
    best = torch.full((B,), NB, dtype=I32, device=dev)
    maxd = torch.full((B,), p_maxdiff, dtype=I32, device=dev)
    num_best = torch.zeros((B,), dtype=IDT, device=dev)
    n_alns, pf, work = zi(), zi(), zi()
    rank_rows, frame_rd, frame_wr, root_rd = zi(), zi(), zi(), zi()
    ovwhy = zi()                       # overflow reason bits
    oA = torch.zeros((B, 7, ACAP), dtype=IDT, device=dev)
    xL = torch.zeros((B, XC), dtype=IDT, device=dev)
    xU = torch.full((B, XC), -1, dtype=IDT, device=dev)
    x_cnt, x_j, x_node, x_m1, x_m2 = zi(), zi(), zi(), zi(), zi()

    # up-front N-count discard (inexact_match.c:259-266)
    pos = torch.arange(Lmax, dtype=I32, device=dev)[None, :]
    n_count = ((rc > 3) & (pos < lengths[:, None])).sum(dim=1)
    discard = n_count > p_maxdiff
    if S.seeded:
        discard = discard | (scnt == 0)     # no seed hit
    mode = torch.where(discard, MODE_DONE, MODE_DFS).to(I32)

    col_a = torch.arange(ACAP, dtype=I32, device=dev)[None, :]
    ar_nw = torch.arange(NW, dtype=torch.int64, device=dev)[None, :]
    match_t = torch.from_numpy(_MATCH).to(dev)
    states_t = torch.from_numpy(slot_states(NC).astype(np.int32)).to(dev)
    gray4_t = torch.from_numpy(_GRAY4).to(dev)
    chars_t = torch.tensor(chars, dtype=torch.int64, device=dev)
    # rank-vector column of each code: the code itself, or 1 + its position
    rank_slot_t = chars_t if S.multiref else torch.arange(
        1, NC + 1, dtype=torch.int64, device=dev)
    code_pos_t = torch.arange(NC, dtype=I32, device=dev)
    not_n_t = chars_t != C.ORDER_N
    is_snp_t = torch.from_numpy(_IS_SNP).to(dev)[chars_t]
    slot_t = torch.arange(NSLOT, dtype=I32, device=dev)
    earlier_t = slot_t[None, :] < slot_t[:, None]      # [slot, earlier slot]

    def flag(ix, mask, why):
        """Set overflow reason `why` on the lanes of `ix` under `mask`."""
        ovwhy[ix] = ovwhy[ix] | (mask.to(I32) * why)

    def retire(ix, mask):
        """Lanes of `ix` under `mask` are done (no host sync)."""
        mode[ix] = torch.where(mask, MODE_DONE, mode[ix]).to(I32)

    def rows_where(mask, *vs):
        """The rows of each of `vs` where `mask` holds, with one host sync
        for all of them (a boolean index syncs once per tensor)."""
        keep = mask.nonzero()[:, 0]
        return tuple(v.index_select(0, keep) for v in vs)

    def score_of(mm, go, ge):
        return mm * p_mm + go * p_go + ge * p_ge

    def in_table(i):
        """rank queries that read a table row (not the edge paths i < 0
        and i == LEN - 1)."""
        return ((i >= 0) & (i != LEN - 1)).to(I32)

    def emit_alns(ix, node, m1, m2, Ls, Us, cnt, extra_m):
        """Record alignments for lanes `ix` (inexact_match.c:331-375 and
        add_alignment's gap dedup, align.c:271-298); returns the lanes whose
        read is finished (max_best stop or ACAP overflow)."""
        _i, mm, go, ge, _st, plen = _unpack1(m1)
        snp = m2 & 0xFF
        score = score_of(mm, go, ge)
        first = n_alns[ix] == 0
        best[ix] = torch.where(first, score, best[ix])
        maxd[ix] = torch.where(first, (mm + go + ge + 1).clamp(max=p_maxdiff),
                               maxd[ix])
        K = Ls.shape[1]
        livek = torch.arange(K, dtype=I32, device=dev)[None, :] < cnt[:, None]
        width = torch.where(livek, Us - Ls + 1, torch.zeros_like(Ls)
                            ).sum(dim=1)
        is_best = score == best[ix]
        old = num_best[ix]
        nb = old.long() + width.long()
        num_best[ix] = torch.where(is_best, nb if S.x64 else _wrap32(nb),
                                   old)
        fin = ~is_best & (old > p_maxbest)        # stop this read
        oa = oA[ix]
        na = n_alns[ix]
        ovl = torch.zeros_like(fin)
        add_len = plen + extra_m
        for s in range(int(cnt.max())):
            Lv, Uv = Ls[:, s], Us[:, s]
            ok = ~fin & (s < cnt)
            dup = ((oa[:, 0] == Lv[:, None]) & (oa[:, 1] == Uv[:, None])
                   & (col_a < na[:, None])).any(dim=1)
            ok = ok & ~(dup & (go > 0))
            full = ok & (na >= ACAP)
            ovl = ovl | full
            fin = fin | full
            ok = ok & ~full
            rows = ok.nonzero()[:, 0]
            if rows.numel():
                vals = torch.stack([v.to(IDT) for v in (
                    Lv, Uv, score, add_len, node, m1, snp)], dim=1)
                oa[rows, :, na[rows].long()] = vals[rows]
            na = na + ok.to(I32)
        oA[ix] = oa
        n_alns[ix] = na
        flag(ix, ovl, OV_ACAP)
        return fin

    def exact_step(ix):
        """One character of the exact-completion scan for lanes `ix`."""
        j = x_j[ix]
        c = rc[ix, j.clamp(0, Lmax - 1).long()]
        Ls, Us, cnt = xL[ix], xU[ix], x_cnt[ix]
        live = ((torch.arange(XC, dtype=I32, device=dev)[None, :]
                 < cnt[:, None]) & (c < 4)[:, None]).to(I32)
        rank_rows[ix] += ((in_table(Ls - 1) + in_table(Us)) * live
                          ).sum(dim=1).to(I32)
        if S.multiref:
            # on the CPU only the columns that hold live slots are expanded
            # (dead slots yield no candidates), into lists of the full
            # capacity XC; on a card, reading the live width would add a
            # host sync an iteration, so all XC columns are expanded
            kl = max(1, int(cnt.max())) if dev.type == "cpu" else XC
            nL, nU, ncnt, _w, ov = expand_step(didx, Ls[:, :kl], Us[:, :kl],
                                               cnt, c, cap=XC)
        else:
            # single-interval 1-to-1 scan (exact_match_1to1_bounded)
            gc = gray4_t[c.clamp(0, 4).long()]
            occL, occU = rank1_pair(didx, gc, Ls[:, 0] - 1, Us[:, 0])
            Cc = didx.Carr[gc.long()]
            L1, U1 = Cc + occL + 1, Cc + occU
            dead = (c > 3) | (L1 > U1)
            nL, nU = Ls.clone(), Us.clone()
            nL[:, 0] = torch.where(dead, 0, L1).to(IDT)
            nU[:, 0] = torch.where(dead, -1, U1).to(IDT)
            ncnt = (~dead).to(I32)
            ov = torch.zeros_like(dead)
        work[ix] += 1
        nj = j - 1
        xL[ix], xU[ix], x_cnt[ix], x_j[ix] = nL, nU, ncnt, nj
        flag(ix, ov, OV_LIST)
        finished = ~ov & ((ncnt == 0) | (nj < 0))
        matched = finished & (ncnt > 0)
        new_mode = torch.where(ov, MODE_DONE,
                               torch.where(finished, MODE_DFS, MODE_EXACT)
                               ).to(I32)
        mi = matched.nonzero()[:, 0]
        if mi.numel():
            lx = ix[mi]
            # the scan consumed (e.i) chars => the path extends by e.i
            # implicit matches (inexact_match.c:365)
            fin = emit_alns(lx, x_node[lx], x_m1[lx], x_m2[lx], nL[mi],
                            nU[mi], ncnt[mi], x_m1[lx] & 0xFF)
            new_mode[mi] = torch.where(fin, MODE_DONE, MODE_DFS).to(I32)
        mode[ix] = new_mode

    def dfs_step(ix):
        """One pop (prune / emit / start an exact completion / expand, link
        and write the frame) for lanes `ix`."""
        no = n_open[ix]
        out = (no == 0) | (no > p_maxentries)
        if S.fixed:
            # fixed rule: the work bound binds at an attempted pop
            late = ~out & (work[ix] >= S.max_iters)
            flag(ix, late, OV_WORK)
            out = out | late
        retire(ix, out)
        ix, = rows_where(~out, ix)
        if not ix.numel():
            return
        # ---- pop: lowest occupied bucket, most recent push (heap_pop)
        h = head[ix]
        bucket = (h >= 0).to(I32).argmax(dim=1).to(I32)
        node = h.gather(1, bucket.long()[:, None])[:, 0]
        isroot = node < NROOT
        nn = (node - NROOT).clamp(min=0)
        f = torch.div(nn, NSLOT, rounding_mode="floor")
        s = nn - f * NSLOT
        words = arena[ix[:, None],
                      (f * ROWW + NW * s).long()[:, None] + ar_nw]
        if S.x64:
            wL, wU = _join64(words[:, 0], words[:, 1]), _join64(
                words[:, 2], words[:, 3])
        else:
            wL, wU = words[:, 0], words[:, 1]
        if S.seeded:
            rn = node.clamp(0, NROOT - 1).long()
            rL, rU = sL[ix, rn], sU[ix, rn]
            rm1 = _pack1(lengths[ix] - PK, 0, 0, 0, C.STATE_M, PK)
            rm2 = node << 8                 # link to root node - 1
            root_rd[ix] += isroot.to(I32)
        else:
            rL, rU = 0, LEN - 1
            rm1 = _pack1(lengths[ix], 0, 0, 0, C.STATE_M, 0)
            rm2 = 0
        eL = torch.where(isroot, rL, wL).to(IDT)
        eU = torch.where(isroot, rU, wU).to(IDT)
        m1 = torch.where(isroot, rm1, words[:, NW - 2]).to(I32)
        m2 = torch.where(isroot, rm2, words[:, NW - 1]).to(I32)
        frame_rd[ix] += (~isroot).to(I32)
        head[ix, bucket.long()] = ((m2 >> 8) & 0xFFFFFF) - 1   # 24-bit link
        n_open[ix] -= 1
        work[ix] += 1

        out = bucket > best[ix] + p_mm
        if S.fixed:
            # fixed rule: a pop past the stop check after NFRAME pops
            spent = ~out & (pf[ix] >= NFRAME)
            flag(ix, spent, OV_FRAMES)
            out = out | spent
        retire(ix, out)
        ix, node, eL, eU, m1, m2 = rows_where(~out, ix, node, eL, eU, m1,
                                              m2)
        if not ix.numel():
            return
        # this pop owns frame `pf` whether or not it pushes anything
        myf = pf[ix]
        base = NROOT + myf * NSLOT
        pf[ix] += 1

        ei, emm, ego, ege, est, eplen = _unpack1(m1)
        esnp = m2 & 0xFF
        Dx, Dsx, lenx = D[ix], Ds[ix], lengths[ix]

        def Dp(arr, idx, w):
            return arr[:, :, w].gather(
                1, idx.clamp(0, arr.shape[1] - 1).long()[:, None])[:, 0]

        # ---- prune chain (inexact_match.c:309-328)
        diff_left = maxd[ix] - emm - ego - ege
        D1n = Dp(Dx, ei - 1, 0)
        dls = p_maxdiffseed - emm - ego - ege
        seed_index = ei - (lenx - p_seedlen)
        S1n = Dp(Dsx, seed_index - 1, 0)
        cont = ((diff_left < 0) | ((ei > 0) & (diff_left < D1n))
                | ((seed_index > 0) & (dls < S1n)))
        live = ~cont

        # ---- hit at i == 0 (inexact_match.c:332-344)
        hit = live & (ei == 0)
        hi = hit.nonzero()[:, 0]
        if hi.numel():
            lx = ix[hi]
            fin = emit_alns(lx, node[hi], m1[hi], m2[hi], eL[hi][:, None],
                            eU[hi][:, None],
                            torch.ones_like(lx, dtype=I32),
                            torch.zeros_like(lx, dtype=I32))
            mode[lx] = torch.where(fin, MODE_DONE, MODE_DFS).to(I32)
        live = live & ~hit

        # ---- exact completion when the budget is exhausted (:345-375)
        to_exact = live & (diff_left == 0)
        ti = to_exact.nonzero()[:, 0]
        if ti.numel():
            lx = ix[ti]
            mode[lx] = MODE_EXACT
            x_node[lx], x_m1[lx], x_m2[lx] = node[ti], m1[ti], m2[ti]
            x_j[lx] = ei[ti] - 1
            x_cnt[lx] = 1
            nl = torch.zeros((ti.numel(), XC), dtype=IDT, device=dev)
            nu = torch.full((ti.numel(), XC), -1, dtype=IDT, device=dev)
            nl[:, 0] = eL[ti]
            nu[:, 0] = eU[ti]
            xL[lx], xU[lx] = nl, nu
        live = live & ~to_exact

        # ---- expansion (inexact_match.c:377-504)
        path_over = live & (eplen + 1 >= PATHCAP)
        flag(ix, path_over, OV_PATH)
        retire(ix, path_over)
        live = live & ~path_over
        (ix, node, eL, eU, ei, emm, ego, ege, est, eplen, esnp, diff_left,
         D1n, dls, seed_index, S1n, Dx, Dsx, lenx, myf, base) = rows_where(
            live, ix, node, eL, eU, ei, emm, ego, ege, est, eplen, esnp,
            diff_left, D1n, dls, seed_index, S1n, Dx, Dsx, lenx, myf, base)
        n = ix.numel()
        if not n:
            return
        if S.multiref:
            Lv, Uv = rank_all_dfs_pair(didx, eL - 1, eU)
        else:
            Lv, Uv = rank_actg_dfs_pair(didx, eL - 1, eU)
        rank_rows[ix] += in_table(eL - 1) + in_table(eU)

        D2n = Dp(Dx, ei - 2, 0)
        D1w, D2w = Dp(Dx, ei - 1, 1), Dp(Dx, ei - 2, 1)
        S2n = Dp(Dsx, seed_index - 2, 0)
        S1w, S2w = Dp(Dsx, seed_index - 1, 1), Dp(Dsx, seed_index - 2, 1)
        pm = ei - 1 > 0
        ad1 = diff_left - 1 < D2n
        am1 = ((D1n == diff_left - 1) & (D2n == diff_left - 1)
               & (D1w == D2w))
        ps = seed_index - 1 > 0
        ad2 = dls - 1 < S2n
        am2 = (S1n == dls - 1) & (S2n == dls - 1) & (S1w == S2w)
        allow_diff = ~(pm & ad1) & ~(ps & ad2)
        allow_mm = ~(pm & ~ad1 & am1) & ~(ps & ~ad2 & am2)

        tmp = ego + ege
        allow_indels = ~(((ei - 1) < (p_noindel + tmp))
                         | ((lenx - (ei - 1)) < (p_noindel + tmp)))
        allow_indels = allow_indels & ~((ego >= p_maxgapo)
                                        & (ege >= p_maxgape))
        allow_open = ego < p_maxgapo
        allow_extend = ege < p_maxgape
        c = rc[ix, (ei - 1).clamp(0, Lmax - 1).long()].clamp(0, 4)
        is_I = est == C.STATE_I
        is_M = est == C.STATE_M
        ind_ok = allow_diff & allow_indels
        nplen = eplen + 1

        def per_code(v):
            """A per-lane value repeated over the NC codes."""
            return v[:, None].expand(n, NC)

        # slot 0: insertion (extend if state == I else open if state == M)
        valid0 = ind_ok & ((is_I & allow_extend) | (is_M & allow_open))
        go0 = ego + is_M.to(I32)
        ge0 = ege + is_I.to(I32)
        m1_0 = _pack1(ei - 1, emm, go0, ge0, C.STATE_I, nplen)
        sc_0 = score_of(emm, go0, ge0)

        # the NC codes at once, in slot order (column t is code chars[t])
        Lc, Uc = Lv[:, rank_slot_t], Uv[:, rank_slot_t]       # [n, NC]
        nonempty = Lc <= Uc
        mm_branch = allow_diff & allow_mm
        # slots 1..NC: deletion, consumes a reference char and keeps i
        god = ego + is_M.to(I32)
        ged = ege + (~is_M).to(I32)
        validD = per_code(ind_ok & ~is_I & ((is_M & allow_open)
                                        | (~is_M & allow_extend))) & nonempty
        m1_D = per_code(_pack1(ei, emm, god, ged, C.STATE_D, nplen))
        sc_D = per_code(score_of(emm, god, ged))
        # slots NC+1..2NC: match/mismatch (or exact-only continuation when
        # mismatches are suppressed)
        if S.multiref:
            is_match = (per_code(c <= 3) & not_n_t[None, :]
                        & (match_t[c.long()][:, chars_t] > 0))
            snp_M = (per_code(esnp) + is_snp_t[None, :]) & 0xFF
        else:
            is_match = per_code(c) == code_pos_t[None, :]
            snp_M = per_code(esnp)
        ok_mm = per_code(mm_branch) & nonempty
        ok_ex = per_code(~mm_branch & (c < 4)) & is_match & nonempty
        mmn = per_code(emm) + (ok_mm & ~is_match).to(I32)
        m1_M = _pack1(per_code(ei - 1), mmn, per_code(ego), per_code(ege),
                      C.STATE_M, per_code(nplen))
        sc_M = score_of(mmn, per_code(ego), per_code(ege))

        valid = torch.cat([valid0[:, None], validD, ok_mm | ok_ex], dim=1)
        candL = torch.cat([eL[:, None], Lc, Lc], dim=1).to(IDT)
        candU = torch.cat([eU[:, None], Uc, Uc], dim=1).to(IDT)
        candM1 = torch.cat([m1_0[:, None], m1_D, m1_M], dim=1).to(I32)
        candSc = torch.cat([sc_0[:, None], sc_D, sc_M], dim=1).to(I32)
        candSnp = torch.cat([esnp[:, None], per_code(esnp), snp_M], dim=1
                            ).to(I32)

        # sequential LIFO push of slots 0..NSLOT-1 into the score buckets
        # (inexact_match.c:510-610), all slots at once: a slot links to the
        # last valid earlier slot of its bucket, else to the bucket's head;
        # the last valid slot of a bucket becomes its head
        hsub = head[ix]
        b = candSc.clamp(0, NB - 1).long()
        same = (b[:, :, None] == b[:, None, :]) & valid[:, None, :]
        before = torch.where(same & earlier_t[None], slot_t[None, None, :],
                             -1).max(dim=2).values            # [n, NSLOT]
        prev_s = torch.where(before >= 0, base[:, None] + before,
                             hsub.gather(1, b)).to(I32)
        candM2 = candSnp | _wrap32((prev_s.long() + 1) << 8)
        last = valid & ~(same & earlier_t.T[None]).any(dim=2)
        rows, sl = last.nonzero(as_tuple=True)
        hsub[rows, b[rows, sl]] = (base[rows] + sl).to(I32)
        head[ix] = hsub
        total = valid.sum(dim=1).to(I32)
        # invalid slots still occupy the row; they are simply never linked
        if S.x64:
            words = [_wrap32(candL & 0xFFFFFFFF), (candL >> 32).to(I32),
                     _wrap32(candU & 0xFFFFFFFF), (candU >> 32).to(I32)]
        else:
            words = [candL, candU]
        frow = torch.cat(
            [torch.stack(words + [candM1, candM2], dim=2
                         ).reshape(n, NSLOT * NW), node[:, None]], dim=1)
        cols = (myf * ROWW).long()[:, None] + torch.arange(
            PAR + 1, dtype=torch.int64, device=dev)[None, :]
        arena[ix[:, None], cols] = frow
        frame_wr[ix] += (total > 0).to(I32)
        n_open[ix] += total

    # ------------------------------------------------------------ main loop
    while True:
        act = mode != MODE_DONE
        if S.fixed:
            # only a scan in flight is checked here; pops check themselves
            late = (mode == MODE_EXACT) & (work >= S.max_iters)
            spent = torch.zeros_like(late)
        else:
            # ring budget (NFRAME of the read's own pops) and work bound
            spent = act & (pf >= NFRAME)
            late = act & ~spent & (work >= S.max_iters)
        ovwhy |= spent.to(I32) * OV_FRAMES + late.to(I32) * OV_WORK
        mode = torch.where(spent | late, MODE_DONE, mode).to(I32)
        ex = (mode == MODE_EXACT).nonzero()[:, 0]
        df = (mode == MODE_DFS).nonzero()[:, 0]
        if not (ex.numel() or df.numel()):
            break
        if ex.numel():
            exact_step(ex)
        if df.numel():
            dfs_step(df)

    # ---- walk the parent chains of the reported alignments: entry t is
    # the state of the t-th ancestor (node first, root excluded)
    paths = torch.zeros((B, ACAP, PATHCAP), dtype=torch.int8, device=dev)
    cur = torch.where((col_a < n_alns[:, None]) & (ovwhy == 0)[:, None],
                      oA[:, 4, :], -1).to(I32)
    lane_col = torch.arange(B, device=dev)[:, None]
    for t in range(PATHCAP):
        alive = cur >= NROOT
        if not bool(alive.any()):
            break
        nn = (cur - NROOT).clamp(min=0)
        f = torch.div(nn, NSLOT, rounding_mode="floor")
        s = nn - f * NSLOT
        par = arena[lane_col, (f * ROWW + PAR).long()]
        paths[:, :, t] = torch.where(alive, states_t[s.long()], 0
                                     ).to(torch.int8)
        frame_rd += alive.sum(dim=1).to(I32)
        cur = torch.where(alive, par, -1).to(I32)

    q_alns.copy_(oA)
    q_paths.copy_(pack_paths(paths))
    q_meta[:, META_NALN] = n_alns
    q_meta[:, META_OVER] = ovwhy
    q_meta[:, META_LANE] = torch.arange(B, dtype=I32, device=dev)
    q_meta[:, META_WORK] = work
    q_meta[:, META_RANK] = rank_rows
    q_meta[:, META_FRD] = frame_rd
    q_meta[:, META_FWR] = frame_wr
    q_meta[:, META_POPS] = pf
    q_meta[:, META_ROOT] = root_rd
    return arena.view(B, NFRAME, ROWW)


def _nseed(seeds) -> int:
    """Root rows a read of a search with `seeds` has (0: unseeded)."""
    return 0 if seeds is None else int(seeds[0].shape[1])


def ring_search_plain(didx: DeviceIndex, rc_all, lengths_all, D_all, Ds_all,
                      params: AlnParams, cfg: EngineConfig, lanes: int,
                      seeds=None):
    """The plain PyTorch version of the ring search: same inputs, outputs
    and per-read semantics as the CUDA kernel (`seeds`: None, or
    (seed_L [Q, S], seed_U [Q, S], seed_cnt [Q]) int32).

    Per-read results do not depend on which lane serves a read or when, so
    this version gives every read a lane of its own and has no refill:
    reads run in chunks of `lanes`, each chunk in lockstep to completion
    (active lanes are compacted every iteration).  That bounds the arena
    to `lanes` columns, as in the kernel."""
    Q, Lmax = rc_all.shape
    S = ring_statics(params, cfg, Lmax, Ds_all.shape[1],
                     seed_slots=_nseed(seeds),
                     x64=didx.idt == torch.int64)
    q_alns, q_meta, q_paths = alloc_outputs(Q, S, rc_all.device)
    lanes = max(1, int(lanes))
    for s in range(0, Q, lanes):
        e = min(s + lanes, Q)
        _plain_chunk(didx, rc_all[s:e], lengths_all[s:e], D_all[s:e],
                     Ds_all[s:e], params, S, q_alns[s:e], q_meta[s:e],
                     q_paths[s:e],
                     None if seeds is None else tuple(x[s:e] for x in seeds))
    return result_dict(q_alns, q_meta, q_paths)


def fixed_search_plain(didx: DeviceIndex, rc, lengths, D, Ds,
                       params: AlnParams, cfg: EngineConfig, seeds=None):
    """The plain PyTorch version of the fixed-batch search: one lane per
    read, the fixed frame-budget rule, the arena returned beside the result
    dict as `arena` [B, NFRAME, ROWW]; `seeds` as for ring_search_plain."""
    B, Lmax = rc.shape
    S = ring_statics(params, cfg, Lmax, Ds.shape[1], fixed=True,
                     seed_slots=_nseed(seeds),
                     x64=didx.idt == torch.int64)
    q_alns, q_meta, q_paths = alloc_outputs(B, S, rc.device)
    arena = _plain_chunk(didx, rc, lengths, D, Ds, params, S, q_alns,
                         q_meta, q_paths, seeds)
    return dict(result_dict(q_alns, q_meta, q_paths), arena=arena)


def _search_inputs(didx, rc, lengths, D, Ds, seed_L, seed_U, seed_cnt,
                   device):
    dev = index_device(didx, device)
    idt = didx.idt

    def on_dev(x, dtype):
        return torch.as_tensor(x).to(dev).to(dtype).contiguous()

    rc = on_dev(rc, torch.int8)
    seeds = None
    given = [x is not None for x in (seed_L, seed_U, seed_cnt)]
    if any(given):
        if not all(given):
            raise ValueError("seed_L, seed_U and seed_cnt go together")
        seeds = (on_dev(seed_L, idt), on_dev(seed_U, idt),
                 on_dev(seed_cnt, torch.int32))
        B = rc.shape[0]
        if (seeds[0].dim() != 2 or seeds[0].shape[0] != B
                or seeds[0].shape[1] < 1
                or seeds[1].shape != seeds[0].shape
                or tuple(seeds[2].shape) != (B,)):
            raise ValueError("seeds must be seed_L/seed_U [B, S] (S >= 1) "
                             "and seed_cnt [B]")
    return (dev, rc, on_dev(lengths, torch.int32), on_dev(D, idt),
            on_dev(Ds, idt), seeds)


def inexact_search(didx: DeviceIndex, rc, lengths, D, D_seed,
                   params: AlnParams, cfg: EngineConfig, seed_L=None,
                   seed_U=None, seed_cnt=None, device=None, timer=None,
                   defer: bool = False):
    """Fixed-batch search: one lane per read; outputs are per-read [B, ...]
    tensors on the device, in read order, plus `paths` (2-bit packed
    reverse-order state walks) and `arena`, the launch's frame rows
    [B, NFRAME, ROWW], over which `walk_paths` reproduces `paths`.

    Args:
      rc:        int8/int32 [B, Lmax] nt4 reverse-complement reads (the
                 search operates on the RC, inexact_match.c:59-65).
      lengths:   int32 [B].
      D, D_seed: [B, *, 2] lower bounds from engine.dbound (in the index's
                 type didx.idt, as are seed_L/seed_U and the reported L/U).
      seed_*:    optional seed-table intervals per read (seed_L/seed_U
                 [B, S], seed_cnt [B]; align.precalc lookup_batch): each
                 read starts from its first seed_cnt (at most S) of them
                 with a params.precalc_len-long all-match path
                 (inexact_match.c:269-282); NROOT = S.
      device:    None means CUDA (raises without one); the tensors and the
                 index must live there.  On a CUDA device the hand-written
                 kernel is launched; the plain version runs only for CPU
                 tensors.
      timer:     None, or an object whose `events` a CUDA launch sets to two
                 CUDA events recorded right around the kernel's launch
                 (engine/kernel.py); unused on the CPU.
      defer:     return a callable that returns the outputs: on a CUDA
                 device everything but the launch is done and the call
                 launches (a mesh launches its members back to back); on
                 the CPU the plain version has run.
    """
    dev, rc, lengths, D, D_seed, seeds = _search_inputs(
        didx, rc, lengths, D, D_seed, seed_L, seed_U, seed_cnt, device)
    if dev.type == "cpu":
        out = fixed_search_plain(didx, rc, lengths, D, D_seed, params, cfg,
                                 seeds)
        return (lambda: out) if defer else out
    from bwbble_tpu_torch.engine import kernel
    return kernel.fixed_search(didx, rc, lengths, D, D_seed, params, cfg,
                               seeds, timer, defer)


def inexact_search_queued(didx: DeviceIndex, rc_all, lengths_all, D_all,
                          Ds_all, params: AlnParams, cfg: EngineConfig,
                          lanes: int, seed_L=None, seed_U=None,
                          seed_cnt=None, device=None, timer=None):
    """Continuous-batching search: `lanes` lanes stream through all NR reads
    (global work queue, queue order = the order given); outputs are per-read
    [NR, ...] tensors on the device.  Arguments as for `inexact_search`.
    The int64 index layout is refused (NotImplementedError), as the JAX
    package refuses it: its queue packs node words through int32 slabs."""
    if didx.idt == torch.int64:
        raise NotImplementedError(QUEUED_I64)
    dev, rc_all, lengths_all, D_all, Ds_all, seeds = _search_inputs(
        didx, rc_all, lengths_all, D_all, Ds_all, seed_L, seed_U, seed_cnt,
        device)
    if dev.type == "cpu":
        return ring_search_plain(didx, rc_all, lengths_all, D_all, Ds_all,
                                 params, cfg, lanes, seeds)
    from bwbble_tpu_torch.engine import kernel
    return kernel.ring_search(didx, rc_all, lengths_all, D_all, Ds_all,
                              params, cfg, lanes, seeds, timer)


def walk_paths(arena: torch.Tensor, lanes: torch.Tensor, nodes: torch.Tensor,
               nroot: int, nslot: int, nc: int, pathcap: int,
               nw: int = 4) -> torch.Tensor:
    """Reverse-order state paths for a flat list of (lane, node) alignments.

    A node's appended state is a static function of its frame slot
    ((node - nroot) % nslot), so only the parent id — word nslot*nw of the
    node's frame row in `arena` [B, F, ROWW] (nw = node words a slot: 4, or
    6 on the int64 layout) — is gathered per step.
    Returns int8 [W, pathcap]; entry t is the state of the t-th ancestor
    (the node itself first; roots contribute nothing)."""
    dev = arena.device
    F = arena.shape[1]
    states = torch.from_numpy(slot_states(nc).astype(np.int32)).to(dev)
    lanes = lanes.to(dev).long()
    cur = nodes.to(dev).to(torch.int32)
    paths = torch.zeros((cur.shape[0], pathcap), dtype=torch.int8, device=dev)
    for t in range(pathcap):
        nn = (cur - nroot).clamp(min=0)
        f = torch.div(nn, nslot, rounding_mode="floor").clamp(0, F - 1)
        par = torch.where(cur >= nroot, arena[lanes, f.long(), nslot * nw],
                          -1).to(torch.int32)
        alive = (cur >= 0) & (par >= 0)
        if not bool(alive.any()):
            break
        slot = torch.where(cur >= nroot, nn % nslot, 0)
        paths[:, t] = torch.where(alive, states[slot.long()], 0
                                  ).to(torch.int8)
        cur = torch.where(alive, par, -1).to(torch.int32)
    return paths
