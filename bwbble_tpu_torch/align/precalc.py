"""Precalculated 12-mer SA-interval seed table (`-P`).

Counterpart of bwbble_tpu/align/precalc.py.  The reference enumerates all
4^12 12-mers and exact-matches each from scratch (precalc_sa_intervals,
align.c:200-224) — 12 full backward-search steps per entry.  The device
build exploits the shared suffix structure instead: level k holds the
interval lists of all 4^k suffixes, and level k+1 extends level k by one
prepended base, so each entry costs ONE batched expansion step (22.4M total
steps vs 201M), through engine.intervals.expand_step on the device.  The
levels stay on the device; past `max_level_full` the table is built in
chunks by leading base(s), and each chunk is compacted on the host.

Table layout is compressed sparse rows (cnt/offset + flat L/U), since most
k-mers have 0–2 intervals.  Entries whose merged list exceeds the device
capacity K are recomputed exactly on the host gold engine, so the table is
always exact.

`.pre` file format is byte-compatible with the reference
(store_sa_interval_list, align.c:144-152): per entry int32 size then
size x (uint64 L, uint64 U).

Everything but `build_precalc_device` and the `device` argument of
`load_or_build_precalc` is the JAX package's code with the package renamed.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

PRECALC_LEN = 12          # PRECALC_INTERVAL_LENGTH (align.h:31)
NUM_PRECALC = 4 ** PRECALC_LEN


@dataclasses.dataclass
class PrecalcTable:
    cnt: np.ndarray   # int32 [N] intervals per k-mer
    off: np.ndarray   # int64 [N+1] CSR offsets
    L: np.ndarray     # int64 [M] flat lower bounds
    U: np.ndarray     # int64 [M] flat upper bounds

    def __len__(self) -> int:
        return self.cnt.shape[0]

    def __getitem__(self, i: int) -> list[tuple[int, int]]:
        a, b = int(self.off[i]), int(self.off[i + 1])
        return [(int(l), int(u)) for l, u in zip(self.L[a:b], self.U[a:b])]

    def lookup_batch(self, ri: np.ndarray, S: int):
        """Gather intervals for k-mer indices ri into [B, S] seed arrays.

        Returns (seed_L, seed_U, seed_cnt int32 [B], overflow bool [B]);
        ri < 0 lanes get cnt 0 (the no-seed-hit discard).  One vectorized
        CSR gather — no per-lane host loop."""
        B = ri.shape[0]
        safe = np.clip(ri, 0, len(self) - 1)
        cnt = np.where(ri < 0, 0, self.cnt[safe]).astype(np.int32)
        overflow = cnt > S
        cs = np.minimum(cnt, S)
        col = np.arange(S, dtype=np.int64)[None, :]
        live = col < cs[:, None]
        M = self.L.shape[0]
        if M == 0:
            return (np.zeros((B, S), np.int64), np.full((B, S), -1, np.int64),
                    cs, overflow)
        take = np.minimum(self.off[safe][:, None] + col, M - 1)
        seed_L = np.where(live, self.L[take], 0)
        seed_U = np.where(live, self.U[take], -1)
        return seed_L, seed_U, cs, overflow


def read_indices(rc: np.ndarray, lengths: np.ndarray, k: int = PRECALC_LEN
                 ) -> np.ndarray:
    """Vectorized read2index (align.c:174-185) over a padded [B, Lmax] batch
    of reverse complements: index of the last k bases, -1 if any N."""
    B, Lmax = rc.shape
    pos = lengths[:, None] - k + np.arange(k)[None, :]
    bad = pos < 0
    digits = rc[np.arange(B)[:, None], np.clip(pos, 0, Lmax - 1)].astype(np.int64)
    has_n = ((digits >= 4) | bad).any(axis=1)
    weights = 4 ** np.arange(k - 1, -1, -1, dtype=np.int64)
    ri = (np.clip(digits, 0, 3) * weights[None, :]).sum(axis=1)
    return np.where(has_n, -1, ri)


# ---------------------------------------------------------------- device build

def build_precalc_device(idx, didx, params, k: int = PRECALC_LEN,
                         K: int = 16, max_level_full: int = 10,
                         sub_batch: int = 65_536, device=None,
                         stats: dict | None = None) -> PrecalcTable:
    """Level-wise table build on the device (exact for every entry).

    idx:    host FMIndex (gold fallback for K-overflow entries)
    didx:   DeviceIndex
    device: None means CUDA (raises without one); the index must live there
    stats:  if given, receives `overflow_entries`, the number of entries
            recomputed on the gold engine
    """
    import torch

    from bwbble_tpu_torch.engine import index_device
    from bwbble_tpu_torch.engine.intervals import expand_step

    dev = index_device(didx, device)
    I32 = torch.int32
    IDT = didx.idt                     # interval type of the index layout

    def extend_batched(Ls, Us, cnt, c):
        """Extend [N, K] lists by per-entry base c, in sub-batches; an
        empty list stays empty under extension (reference semantics)."""
        N = Ls.shape[0]
        outs = ([], [], [], [])
        for s in range(0, N, sub_batch):
            e = min(s + sub_batch, N)
            nLs, nUs, ncnt, _w, ov = expand_step(didx, Ls[s:e], Us[s:e],
                                                 cnt[s:e], c[s:e])
            for o, v in zip(outs, (nLs, nUs, ncnt, ov)):
                o.append(v)
        return tuple(torch.cat(o, dim=0) for o in outs)

    def host(*ts):
        return tuple(t.cpu().numpy() for t in ts)

    # level 1: the four single-base lists from the full range
    Ls = torch.zeros((1, K), dtype=IDT, device=dev)
    Us = torch.full((1, K), -1, dtype=IDT, device=dev)
    Us[0, 0] = int(idx.length) - 1
    cnt = torch.ones((1,), dtype=I32, device=dev)
    over = torch.zeros((1,), dtype=torch.bool, device=dev)

    level = 0
    while level < min(k, max_level_full):
        n = Ls.shape[0]
        # new index = c * 4^level + old  => tile entries 4x, repeat base c
        Ls = Ls.repeat(4, 1)
        Us = Us.repeat(4, 1)
        cnt_t = cnt.repeat(4)
        over = over.repeat(4)
        c = torch.arange(4, dtype=I32, device=dev).repeat_interleave(n)
        Ls, Us, cnt, ov = extend_batched(Ls, Us, cnt_t, c)
        over = over | ov
        level += 1

    if level == k:
        if stats is not None:
            stats["overflow_entries"] = int(over.sum())
        return _finalize(idx, params, *host(Ls, Us, cnt, over), k)

    # remaining levels: chunk by leading base(s) to bound memory
    rem = k - level
    chunks = []
    for lead in range(4 ** rem):
        # final index = lead * 4^level + s; lead's least-significant digit is
        # adjacent to the suffix, so it is prepended first
        cl, cu, cc, co = Ls, Us, cnt, over
        for d in range(rem):
            base = (lead >> (2 * d)) & 3
            c = torch.full((cl.shape[0],), base, dtype=I32, device=dev)
            cl, cu, cc, ov = extend_batched(cl, cu, cc, c)
            co = co | ov
        chunks.append(_compact(*host(cl, cu, cc, co)))
    cnt_a = np.concatenate([x[0] for x in chunks])
    over_a = np.concatenate([x[3] for x in chunks])
    L_a = np.concatenate([x[1] for x in chunks])
    U_a = np.concatenate([x[2] for x in chunks])
    off = np.zeros(cnt_a.shape[0] + 1, dtype=np.int64)
    np.cumsum(cnt_a, out=off[1:])
    table = PrecalcTable(cnt=cnt_a.astype(np.int32), off=off,
                         L=L_a.astype(np.int64), U=U_a.astype(np.int64))
    if stats is not None:
        stats["overflow_entries"] = int(over_a.sum())
    _fix_overflow(table, idx, params, np.nonzero(over_a)[0], k)
    return table


def _compact(Ls, Us, cnt, over):
    K = Ls.shape[1]
    live = np.arange(K)[None, :] < cnt[:, None]
    return (cnt.copy(), Ls[live].astype(np.int64), Us[live].astype(np.int64),
            over.copy())


def _finalize(idx, params, Ls, Us, cnt, over, k) -> PrecalcTable:
    cnt_a, L_a, U_a, over_a = _compact(Ls, Us, cnt, over)
    off = np.zeros(cnt_a.shape[0] + 1, dtype=np.int64)
    np.cumsum(cnt_a, out=off[1:])
    table = PrecalcTable(cnt=cnt_a.astype(np.int32), off=off, L=L_a, U=U_a)
    _fix_overflow(table, idx, params, np.nonzero(over_a)[0], k)
    return table


def _fix_overflow(table: PrecalcTable, idx, params, entries: np.ndarray,
                  k: int) -> None:
    """Recompute K-overflow entries exactly with the host gold engine."""
    if entries.size == 0:
        return
    from bwbble_tpu_torch.gold.engine import exact_match
    rows: dict[int, list[list[int]]] = {}
    for e in entries:
        digits = [(int(e) >> (2 * (k - 1 - t))) & 3 for t in range(k)]
        rows[int(e)] = exact_match(idx, np.array(digits, dtype=np.int8), k,
                                   params)
    # rebuild CSR with corrected rows
    N = len(table)
    new_cnt = table.cnt.copy()
    for e, iv in rows.items():
        new_cnt[e] = len(iv)
    new_off = np.zeros(N + 1, dtype=np.int64)
    np.cumsum(new_cnt, out=new_off[1:])
    L = np.empty(int(new_off[-1]), dtype=np.int64)
    U = np.empty_like(L)
    for e in range(N):
        a, b = int(new_off[e]), int(new_off[e + 1])
        if e in rows:
            if b > a:
                L[a:b] = [v[0] for v in rows[e]]
                U[a:b] = [v[1] for v in rows[e]]
        else:
            oa = int(table.off[e])
            L[a:b] = table.L[oa:oa + b - a]
            U[a:b] = table.U[oa:oa + b - a]
    table.cnt, table.off, table.L, table.U = new_cnt, new_off, L, U


# ----------------------------------------------------------------- .pre codec

def store_pre(path: str, table: PrecalcTable) -> None:
    """Byte-compatible with precalc_sa_intervals' output (align.c:200-224)."""
    N = len(table)
    cnt = table.cnt.astype(np.int64)
    rec_sizes = 4 + 16 * cnt
    rec_off = np.zeros(N + 1, dtype=np.int64)
    np.cumsum(rec_sizes, out=rec_off[1:])
    out = np.empty(int(rec_off[-1]), dtype=np.uint8)
    idx4 = rec_off[:-1, None] + np.arange(4)[None, :]
    out[idx4.reshape(-1)] = (
        table.cnt.astype("<i4").view(np.uint8).reshape(N, 4).reshape(-1))
    M = table.L.shape[0]
    if M:
        ent = np.repeat(np.arange(N, dtype=np.int64), cnt)
        rank = np.arange(M, dtype=np.int64) - table.off[ent]
        iv_off = rec_off[ent] + 4 + 16 * rank
        rec = np.empty((M, 2), dtype="<u8")
        rec[:, 0] = table.L.astype(np.uint64)
        rec[:, 1] = table.U.astype(np.uint64)
        idx16 = iv_off[:, None] + np.arange(16)[None, :]
        out[idx16.reshape(-1)] = rec.view(np.uint8).reshape(-1)
    with open(path, "wb") as f:
        f.write(out.tobytes())


def load_pre(path: str, num_entries: int = NUM_PRECALC) -> PrecalcTable:
    """Parse a `.pre` file (load_precalc_sa_intervals, align.c:226-238)."""
    data = np.fromfile(path, dtype=np.uint8)
    # the record walk is inherently sequential (sizes are data-dependent);
    # at k=12 that is 16.7M iterations, so prefer the native scanner
    from bwbble_tpu_torch.native import get_native
    nat = get_native()
    cnt = nat.pre_scan(data, num_entries) if nat is not None else None
    if cnt is not None:
        cnt = cnt.astype(np.int64)
    else:
        cnt = np.empty(num_entries, dtype=np.int64)
        pos = 0
        for e in range(num_entries):
            c = int(np.frombuffer(data[pos:pos + 4].tobytes(), dtype="<i4")[0])
            cnt[e] = c
            pos += 4 + 16 * c
    off = np.zeros(num_entries + 1, dtype=np.int64)
    np.cumsum(cnt, out=off[1:])
    M = int(off[-1])
    rec_off = np.zeros(num_entries + 1, dtype=np.int64)
    np.cumsum(4 + 16 * cnt, out=rec_off[1:])
    L = np.empty(M, dtype=np.int64)
    U = np.empty(M, dtype=np.int64)
    if M:
        ent = np.repeat(np.arange(num_entries, dtype=np.int64), cnt)
        rank = np.arange(M, dtype=np.int64) - off[ent]
        iv_off = rec_off[ent] + 4 + 16 * rank
        idx16 = iv_off[:, None] + np.arange(16)[None, :]
        rec = data[idx16.reshape(-1)].reshape(M, 16).view("<u8")
        L[:] = rec[:, 0].astype(np.int64)
        U[:] = rec[:, 1].astype(np.int64)
    return PrecalcTable(cnt=cnt.astype(np.int32), off=off, L=L, U=U)


def load_or_build_precalc(idx, params, path: str, engine: str = "device",
                          device=None) -> PrecalcTable:
    """Build the table lazily on first use, like align_reads (align.c:59-66)."""
    k = int(getattr(params, "precalc_len", PRECALC_LEN))
    if not os.path.exists(path):
        print("Pre-calculating SA intervals...")
        if engine == "gold":
            table = build_precalc_gold(idx, params, k=k)
        else:
            from bwbble_tpu_torch.engine.device_index import from_fmindex
            table = build_precalc_device(idx,
                                         from_fmindex(idx, device=device),
                                         params, k=k, device=device)
        store_pre(path, table)
        return table
    return load_pre(path, num_entries=4 ** k)


def build_precalc_gold(idx, params, k: int = PRECALC_LEN) -> PrecalcTable:
    """Host reference build (oracle for tests; slow for k=12)."""
    from bwbble_tpu_torch.gold.engine import exact_match
    N = 4 ** k
    cnt = np.zeros(N, dtype=np.int32)
    Ls: list[int] = []
    Us: list[int] = []
    digits = np.zeros(k, dtype=np.int8)
    for e in range(N):
        iv = exact_match(idx, digits, k, params)
        cnt[e] = len(iv)
        for l, u in iv:
            Ls.append(l)
            Us.append(u)
        # next_read (align.c:187-198): base-4 increment, LSB at the end
        for t in range(k - 1, -1, -1):
            digits[t] += 1
            if digits[t] < 4:
                break
            digits[t] = 0
    off = np.zeros(N + 1, dtype=np.int64)
    np.cumsum(cnt, out=off[1:])
    return PrecalcTable(cnt=cnt, off=off, L=np.array(Ls, dtype=np.int64),
                        U=np.array(Us, dtype=np.int64))
