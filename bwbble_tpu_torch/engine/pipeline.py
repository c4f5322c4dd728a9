"""Device alignment pipeline (queued path): streams reads through the ring
search on the device and falls back to the host gold engine per read on any
capacity overflow, so output is byte-identical to the reference at every
capacity setting.

Counterpart of bwbble_tpu/engine/pipeline.py.  Ported: the D-bound passes
(device `calc_d`, the native unbounded-list scanner and the probe that
chooses between them), difficulty ordering, the queued branch of
`align_reads_device` with its single deep rung, and the overlapped host gold
pool.  Not ported yet (raise NotImplementedError): fixed-batch tiers
(`run_tier`), `-S` single-genome mode, `-P` seeding, the int64 layout and
device meshes.

The gold pool runs on threads, not forked processes: the index is already
on the CUDA device when the pool is made, and a forked child of a process
that holds a CUDA context must never touch it.  The workers spend their
time inside the native gold engine, which ctypes calls with the GIL
released and which keeps its scratch thread-local, so threads overlap the
device launches just as well and need no copy of the index.
"""

from __future__ import annotations

import dataclasses
import time as _tm
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from bwbble_tpu_torch import constants as CN
from bwbble_tpu_torch.align.params import AlnParams
from bwbble_tpu_torch.align.pipeline import align_read_gold
from bwbble_tpu_torch.engine import index_device
from bwbble_tpu_torch.engine.dbound import calc_d
from bwbble_tpu_torch.engine.device_index import DeviceIndex
from bwbble_tpu_torch.engine.inexact import (NB_MAX, NROOT, NSLOT,
                                             EngineConfig,
                                             inexact_search_queued,
                                             unpack_paths)
from bwbble_tpu_torch.formats.fastq import Reads
from bwbble_tpu_torch.gold.engine import Aln
from bwbble_tpu_torch.index.fmindex import FMIndex
from bwbble_tpu_torch.native import get_native

def _reconstruct_path(rev_row: np.ndarray, plen: int, out_len: int,
                      root_plen: int) -> bytes:
    """Rebuild a push-order state path from the device's reverse-order walk
    buffer.  rev_row[t] is the state of the t-th ancestor (node first, root
    excluded); the root's implicit all-match prefix (root_plen zeros) and
    the exact-completion tail (out_len - plen zeros) are match states
    (STATE_M == 0)."""
    chain = bytes(rev_row[:max(plen - root_plen, 0)][::-1])
    path = bytes(root_plen) + chain
    if out_len > len(path):
        path = path + bytes(out_len - len(path))
    return path[:out_len]


def _require_multiref(params: AlnParams) -> None:
    if not params.is_multiref:
        raise NotImplementedError(
            "single-genome (-S) mode (calc_d_1to1, the 4-letter search) is "
            "not ported yet")


def _calc_d_chunk(didx, seq, lengths, lengths_np, params, K):
    """D and D_seed for one padded chunk at interval capacity K; returns
    (D, Ds, overflow) device tensors.  lengths_np mirrors `lengths` for
    host-side masking."""
    _require_multiref(params)
    dev = didx.device
    seed_len = int(params.seed_length)
    seq = torch.as_tensor(seq).to(dev)
    lengths = torch.as_tensor(lengths).to(dev)
    D, dov1 = calc_d(didx, seq, lengths, K=K, device=dev)
    use_seed = (lengths_np > seed_len) & (seed_len > 0)
    sl = torch.from_numpy(np.where(use_seed, seed_len, 0).astype(np.int32))
    Ds, dov2 = calc_d(didx, seq, sl.to(dev), K=K, max_len=max(seed_len, 1),
                      device=dev)
    # reads not using a seed keep an all-zero D_seed (calloc semantics,
    # inexact_match.c:36,62-64)
    use_seed_d = torch.from_numpy(use_seed).to(dev)
    Ds = torch.where(use_seed_d[:, None, None], Ds, torch.zeros_like(Ds))
    return D, Ds, dov1 | (dov2 & use_seed_d)


def _native_d_ok(didx: DeviceIndex, host_idx: FMIndex | None) -> bool:
    nat = get_native()
    return (host_idx is not None and nat is not None
            and getattr(nat, "_has_calc_d", False)
            and host_idx.length == int(didx.length))


def probe_native_d(didx: DeviceIndex, reads: Reads, params: AlnParams,
                   d_cap: int, k_fast: int = 2,
                   host_idx: FMIndex | None = None) -> tuple[int, bool]:
    """(K1, skip): K1 is the device D pass's first-try interval capacity,
    skip=True when the whole device pass should be bypassed for the native
    exact scanner.

    Pure-ACGT references keep lists at width ~1 (k_fast=2 suffices); on
    IUPAC multi-genomes the scan's wide phase carries dozens of disjoint
    intervals on every read, so probe one chunk at k_fast and escalate the
    default width if it overflows.  When even d_cap overflows on >90% of
    the probe chunk, the whole K=d_cap device pass would be discarded
    wholesale for the native scanner, so skip it up front."""
    _require_multiref(params)
    NR = reads.count
    Lmax = max(reads.max_len, 1)
    K1 = min(k_fast, d_cap)
    if not (NR > 0 and d_cap > K1):
        return K1, False
    nat_ok = _native_d_ok(didx, host_idx)
    sq = np.zeros((min(256, max(NR, 1)), Lmax), dtype=np.int8)
    nbp = min(256, NR, sq.shape[0])
    sq[:nbp, :reads.seq.shape[1]] = reads.seq[:nbp]
    lnp = np.zeros((sq.shape[0],), dtype=np.int32)
    lnp[:nbp] = reads.lengths[:nbp]
    _, _, dovp = _calc_d_chunk(didx, sq, lnp, lnp, params, K1)
    if dovp.cpu().numpy()[:nbp].mean() > 0.5:
        K1 = d_cap
        if nat_ok:
            _, _, dovp2 = _calc_d_chunk(didx, sq, lnp, lnp, params, d_cap)
            if dovp2.cpu().numpy()[:nbp].mean() > 0.9:
                return K1, True
    return K1, False


def _native_d_read(nat, host_idx, planes, fused, nb_tab, seq, ln_r,
                   seed_len, D_row, Ds_row) -> None:
    """Exact D / D_seed of one read from the native scanner, in place."""
    D_row[:ln_r + 1] = nat.calc_d_multiref(
        planes, host_idx.occ, host_idx.Carr, host_idx.length, host_idx.sa0,
        CN.OCC_INTERVAL, nb_tab, seq, ln_r, fused=fused)
    if ln_r > seed_len and seed_len > 0:
        Ds_row[:seed_len + 1] = nat.calc_d_multiref(
            planes, host_idx.occ, host_idx.Carr, host_idx.length,
            host_idx.sa0, CN.OCC_INTERVAL, nb_tab, seq, seed_len,
            fused=fused)


def calc_d_all(didx: DeviceIndex, reads: Reads, params: AlnParams,
               batch: int, d_cap: int = 16, k_fast: int = 2,
               host_idx: FMIndex | None = None):
    """D/D_seed bounds for every read: one cheap K=k_fast pass (exact unless
    a read's interval list overflows k_fast slots), then a K=d_cap re-run
    for just the overflowing reads, then the native unbounded-list scanner
    for what still overflows.  Returns (D_all, Ds_all device tensors,
    overflow np.bool_[NR] — reads still overflowing).

    The reference recomputes these per read with unbounded linked lists
    (calculate_d, inexact_match.c:171-254)."""
    NR = reads.count
    Lmax = max(reads.max_len, 1)
    dev = didx.device
    K1, skip = probe_native_d(didx, reads, params, d_cap, k_fast, host_idx)
    if skip:
        return _calc_d_native_all(didx, host_idx, reads, params, batch)
    D_parts, Ds_parts, dov_parts = [], [], []
    for s in range(0, NR, batch):
        e = min(s + batch, reads.count)
        nb = e - s
        sq = np.zeros((batch, Lmax), dtype=np.int8)
        sq[:nb, :reads.seq.shape[1]] = reads.seq[s:e]
        ln = np.zeros((batch,), dtype=np.int32)
        ln[:nb] = reads.lengths[s:e]
        D, Ds, dov = _calc_d_chunk(didx, sq, ln, ln, params, K1)
        D_parts.append(D[:nb])
        Ds_parts.append(Ds[:nb])
        dov_parts.append(dov.cpu().numpy()[:nb])
    D_all = torch.cat(D_parts)
    Ds_all = torch.cat(Ds_parts)
    dov_all = np.concatenate(dov_parts)

    retry = np.flatnonzero(dov_all)
    if retry.size and d_cap > K1:
        dov_all = np.zeros(NR, dtype=bool)
        for rs in range(0, retry.size, batch):
            sub = retry[rs:rs + batch]
            sel = np.concatenate([sub, np.full(batch - sub.size, sub[0],
                                               dtype=sub.dtype)])
            sq = np.zeros((batch, Lmax), dtype=np.int8)
            sq[:, :reads.seq.shape[1]] = reads.seq[sel]
            ln = reads.lengths[sel].astype(np.int32)
            D, Ds, dov = _calc_d_chunk(didx, sq, ln, ln, params, d_cap)
            sidx = torch.from_numpy(sub.astype(np.int64)).to(dev)
            n = sub.size
            D_all[sidx] = D[:n]
            Ds_all[sidx] = Ds[:n]
            dov_all[sub] = dov.cpu().numpy()[:n]

    # final escalation: reads whose interval lists exceed even d_cap slots
    # get exact D bounds from the native unbounded-list scanner, so D
    # overflow never forces whole-read gold fallback
    still = np.flatnonzero(dov_all)
    if still.size and _native_d_ok(didx, host_idx):
        nat = get_native()
        nb_tab = np.ascontiguousarray(CN.NUCL_BASES, dtype=np.uint8)
        planes = host_idx.bit_planes()
        fused = host_idx.fused_planes()
        seed_len = int(params.seed_length)
        Dp = np.zeros((still.size,) + tuple(D_all.shape[1:]), dtype=np.int32)
        Dsp = np.zeros((still.size,) + tuple(Ds_all.shape[1:]),
                       dtype=np.int32)
        for t, r in enumerate(still):
            _native_d_read(nat, host_idx, planes, fused, nb_tab,
                           reads.seq[r], int(reads.lengths[r]), seed_len,
                           Dp[t], Dsp[t])
        sidx = torch.from_numpy(still.astype(np.int64)).to(dev)
        D_all[sidx] = torch.from_numpy(Dp).to(dev)
        Ds_all[sidx] = torch.from_numpy(Dsp).to(dev)
        dov_all[still] = False
    return D_all, Ds_all, dov_all


def native_scan_chunks(host_idx: FMIndex, reads: Reads, params: AlnParams,
                       batch: int):
    """Generator: exact D/D_seed bounds from the native unbounded-list
    scanner (the reference's calculate_d semantics at any interval-list
    width, inexact_match.c:171-254), one `batch`-read chunk at a time.
    Yields (indices, D_chunk, Ds_chunk, difficulty); the difficulty proxy
    comes from the exact scanned widths.  With params.n_threads > 1 the
    reads of a chunk are scanned on that many threads (the scanner runs
    with the GIL released and keeps its scratch thread-local)."""
    nat = get_native()
    if nat is None or not getattr(nat, "_has_calc_d", False):
        raise RuntimeError(
            "native_scan_chunks needs the native library (python -m "
            "bwbble_tpu_torch.build_native)")
    NR = reads.count
    Lmax = max(reads.max_len, 1)
    seed_len = int(params.seed_length)
    nb_tab = np.ascontiguousarray(CN.NUCL_BASES, dtype=np.uint8)
    planes = host_idx.bit_planes()
    fused = host_idx.fused_planes()
    n_threads = max(1, int(params.n_threads))
    with ThreadPoolExecutor(n_threads) as ex:
        for s in range(0, NR, batch):
            e = min(s + batch, NR)
            Dch = np.zeros((e - s, Lmax + 1, 2), dtype=np.int32)
            Dsch = np.zeros((e - s, max(seed_len, 1) + 1, 2),
                            dtype=np.int32)

            def scan(lo, hi, s=s, Dch=Dch, Dsch=Dsch):
                for r in range(lo, hi):
                    _native_d_read(nat, host_idx, planes, fused, nb_tab,
                                   reads.seq[r], int(reads.lengths[r]),
                                   seed_len, Dch[r - s], Dsch[r - s])

            step = -(-(e - s) // n_threads)
            for f in [ex.submit(scan, lo, min(lo + step, e))
                      for lo in range(s, e, step)]:
                f.result()
            yield (np.arange(s, e, dtype=np.int64), Dch, Dsch,
                   _difficulty(Dch))


def _calc_d_native_all(didx: DeviceIndex, host_idx: FMIndex, reads: Reads,
                       params: AlnParams, batch: int):
    """Materialized native_scan_chunks: exact D bounds for every read."""
    NR = reads.count
    Lmax = max(reads.max_len, 1)
    seed_len = int(params.seed_length)
    D_np = np.zeros((NR, Lmax + 1, 2), dtype=np.int32)
    Ds_np = np.zeros((NR, max(seed_len, 1) + 1, 2), dtype=np.int32)
    for gi, Dch, Dsch, _zc in native_scan_chunks(host_idx, reads, params,
                                                 batch):
        D_np[gi[0]:gi[-1] + 1] = Dch
        Ds_np[gi[0]:gi[-1] + 1] = Dsch
    dev = didx.device
    return (torch.from_numpy(D_np).to(dev), torch.from_numpy(Ds_np).to(dev),
            np.zeros(NR, dtype=bool))


def _difficulty(D_np: np.ndarray) -> np.ndarray:
    return (-64.0 * np.sum(np.log2(1.0 + D_np[:, :, 1].astype(np.float64)),
                           axis=1)).astype(np.int64)


def difficulty_scores(D_all) -> np.ndarray:
    """Cheap per-read difficulty proxy, derived for free from the D pass:
    search work anti-correlates with SA-interval width (wide intervals =>
    the read matches many loci, finds its best quickly and max_best stops
    it; narrow => deep lonely exploration), so the proxy is the negated
    total log-width and ascending order = easiest first.  Computed on the
    host in float64, whichever pass produced D, so routing is
    reproducible."""
    if torch.is_tensor(D_all):
        D_all = D_all.cpu().numpy()
    return _difficulty(np.asarray(D_all))


def device_params_ok(params: AlnParams, max_len: int) -> bool:
    """True when the device engine's packed-word domain covers `params`
    (meta1 layout: mm 5 bits, go 3, ge 4, i 8, plen 9; score buckets
    bounded).  Outside it — the reference accepts e.g. -o 7 or -n 31
    (main.c:100-117) — alignment routes to the host gold engine."""
    nb = ((int(params.max_diff) + 1) * int(params.mm_score)
          + (int(params.max_gapo) + 1) * int(params.gapo_score)
          + (int(params.max_gape) + 1) * int(params.gape_score))
    return (int(params.max_diff) + 1 <= 31
            and int(params.max_gapo) + 1 <= 7
            and int(params.max_gape) + 1 <= 15
            and max_len <= 255
            and 0 < nb <= NB_MAX)


def align_reads_device(idx: FMIndex, didx: DeviceIndex, reads: Reads,
                       params: AlnParams, cfg: EngineConfig | None = None,
                       d_cap: int = 32, stats: dict | None = None,
                       precalc=None, seed_slots: int = 32,
                       sort_reads: bool = True, queued: bool = False,
                       qchunk: int = 2, mesh=None,
                       device=None) -> list[list[Aln]]:
    """Align all reads on the device; returns per-read alignment lists in
    the reference's discovery order (byte-parity with align_reads_inexact).

    `queued`: continuous batching (lanes stream reads from a global queue),
    the one search path ported so far; it is taken when the read set spans
    more than one batch, as in the JAX package.  `device`: None means CUDA
    (raises without one); the index must live there.
    """
    cfg = cfg or EngineConfig()
    index_device(didx, device)
    if mesh is not None:
        raise NotImplementedError("device meshes (parallel/) are not "
                                  "ported yet")
    if precalc is not None or params.use_precalc:
        raise NotImplementedError("-P seeded search (align/precalc.py, "
                                  "NROOT > 1) is not ported yet")
    _require_multiref(params)
    if not device_params_ok(params, max(reads.max_len, 1)):
        counters = {"fallback_reads": reads.count, "retried_reads": 0,
                    "t_dbounds": 0.0, "gold_routed": True}
        if stats is not None:
            stats.update(counters)
        out: list = [None] * reads.count
        for orig, alns in gold_fallback_many(
                idx, reads, list(range(reads.count)), params,
                int(params.n_threads)).items():
            out[orig] = alns
        return out
    if queued and reads.count > int(params.batch_size):
        return _align_queued(idx, didx, reads, params, cfg, d_cap, stats,
                             sort_reads, qchunk=qchunk)
    raise NotImplementedError(
        "fixed-batch search (run_tier / inexact_search) is not ported yet: "
        "pass queued=True (CLI: --queued) with more reads than "
        "params.batch_size")


class _GoldPool:
    """Host-gold worker threads that run concurrently with device launches
    (see the module docstring for why threads).  Submissions ship read
    indices; results are gathered by `drain`."""

    def __init__(self, idx, reads: Reads, params: AlnParams,
                 n_workers: int = 1):
        idx.bit_planes()              # materialize the shared rank planes
        idx.fused_planes()            # before any worker needs them
        self._idx, self._reads, self._params = idx, reads, params
        self._ex = ThreadPoolExecutor(max(1, int(n_workers)))
        self._futs: list = []
        self.submitted = 0

    def submit(self, sel) -> None:
        for i in sel:
            i = int(i)
            self._futs.append((i, self._ex.submit(
                _fb_single, self._idx, self._reads, i, self._params)))
            self.submitted += 1

    def drain(self) -> dict[int, list]:
        out = {i: f.result() for i, f in self._futs}
        self._futs = []
        self._ex.shutdown(wait=True)
        return out

    def terminate(self) -> None:
        self._ex.shutdown(wait=True, cancel_futures=True)


def gold_fallback_many(idx, reads: Reads, sel: list[int], params: AlnParams,
                       n_threads: int) -> dict[int, list]:
    """Gold-align reads[sel]; with n_threads > 1 worker threads spread the
    reads so overflow storms degrade gracefully."""
    if n_threads <= 1 or len(sel) <= 1:
        return {i: _fb_single(idx, reads, i, params) for i in sel}
    pool = _GoldPool(idx, reads, params, min(int(n_threads), len(sel)))
    try:
        pool.submit(sel)
        return pool.drain()
    finally:
        pool.terminate()


def _fb_single(idx, reads, i, params):
    return align_read_gold(idx, reads.seq[i], reads.rc[i],
                           int(reads.lengths[i]), params)


def _pow2_at_least(n: int, lo: int = 256) -> int:
    return max(lo, 1 << (int(n) - 1).bit_length())


def _align_queued(idx, didx, reads: Reads, params: AlnParams,
                  cfg: EngineConfig, d_cap: int, stats, sort_reads: bool,
                  qchunk: int = 16) -> list:
    """Continuous batching: engine launches stream reads through a fixed
    set of lanes (hardest reads first — LPT scheduling).

    Every read gets a full cfg.cap frame budget of its own, and parent
    chains are walked when a read finishes, so one launch can stream
    arbitrarily many reads; qchunk*lanes reads go into one launch.  Reads
    that overflow their per-read budget retry at a deep rung of fewer
    lanes and a larger budget, and only persistent failures reach the host
    gold engine.
    """
    t_start = _tm.time()
    NR = reads.count
    dev = didx.device
    lanes = min(int(params.batch_size), _pow2_at_least(NR, lo=256))
    # exact completion over lists of up to 128 intervals: covers the
    # IUPAC-dense reads a handful of kx slots would ship to the host
    cfg = dataclasses.replace(cfg, xcap=128)

    # overlapped host-gold pool, made before the D pass so pre-routed
    # reads keep the host busy while the device searches
    pool: _GoldPool | None = None
    nat = get_native()
    if nat is not None and getattr(nat, "_has_gold", False) and NR > lanes:
        pool = _GoldPool(idx, reads, params,
                         n_workers=max(1, int(params.n_threads)))

    try:
        # one forward D pass: search bounds + difficulty ordering
        Dr_all, Dsr_all, dov_raw = calc_d_all(
            didx, reads, params, batch=min(lanes, _pow2_at_least(NR)),
            d_cap=d_cap, host_idx=idx)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t_dbounds = _tm.time() - t_start
        z = difficulty_scores(Dr_all)
        if sort_reads:
            order = np.argsort(-z, kind="stable").astype(np.int64)
        else:
            order = np.arange(NR, dtype=np.int64)

        # Routing budget, derived from a <5% fallback target (4.5% leaves
        # margin): the proxy's hardest reads are the ones that would burn
        # the deepest ring budgets, and the ladder resolves everything else
        # on the device, so the pre-routed slice is the fallback set.
        budget = int(0.045 * NR) if (pool is not None and sort_reads) else 0
        routed = np.zeros(NR, dtype=bool)
        if budget >= 32:
            pre = order[:budget]
            routed[pre] = True
            pool.submit(pre)
        order = order[~(routed[order] | dov_raw[order])]
        dov_sel = np.flatnonzero(dov_raw & ~routed)
        if dov_sel.size and pool is not None:
            pool.submit(dov_sel)

        Lmax = max(reads.max_len, 1)
        pathcap = cfg.pathcap or (Lmax + 32)
        out: list = [None] * NR
        counters = {"work_units": 0, "pops": 0, "rank_rows": 0,
                    "frame_rd_rows": 0, "frame_wr_rows": 0, "launches": 0}
        t_search = 0.0
        pass_log: list[dict] = []
        pending_assembly: list[dict] = []

        def ring_pass(sub: np.ndarray, lanes_p: int, cfg_p: EngineConfig,
                      qchunk_p: int) -> list[int]:
            """Stream reads[sub] (absolute ids, hardest-first) through the
            queued engine at lanes_p lanes; fills `out`, returns the ids
            that overflowed their per-read ring budget."""
            nonlocal t_search
            NQ = sub.size
            rc_s = np.zeros((NQ, Lmax), dtype=np.int8)
            rc_s[:, :reads.rc.shape[1]] = reads.rc[sub]
            rc_d = torch.from_numpy(rc_s).to(dev)
            len_d = torch.from_numpy(
                reads.lengths[sub].astype(np.int32)).to(dev)
            subj = torch.from_numpy(sub.astype(np.int64)).to(dev)
            D_s = Dr_all.index_select(0, subj)
            Ds_s = Dsr_all.index_select(0, subj)
            nframe = max((int(cfg_p.cap) - NROOT) // NSLOT - 1, 2)
            Q = max(1, int(qchunk_p)) * lanes_p
            # a read's work bound must not bind before its ring budget
            need = (int(qchunk_p) + 2) * nframe + 4096
            cfg_r = dataclasses.replace(
                cfg_p, max_iters=max(int(cfg_p.max_iters), need))
            t0p = _tm.time()
            wk0 = counters["work_units"]
            failed_p: list[int] = []

            def dispatch(cs: int) -> dict:
                ce = min(cs + Q, NQ)
                ev = None
                t0 = _tm.time()
                if dev.type == "cuda":
                    ev = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
                    ev[0].record()
                res = inexact_search_queued(
                    didx, rc_d[cs:ce], len_d[cs:ce], D_s[cs:ce],
                    Ds_s[cs:ce], params, cfg_r, lanes=lanes_p, device=dev)
                if ev is not None:
                    ev[1].record()
                return dict(cs=cs, nb=ce - cs, res=res, ev=ev,
                            sec=_tm.time() - t0)

            def collect_h(h: dict) -> None:
                """Block on the launch and extract the cheap outputs
                (failed ids, counters); the Python-side Aln assembly is
                deferred so it can run while the next launch computes."""
                nonlocal t_search
                cs, nb, res = h["cs"], h["nb"], h["res"]
                if h["ev"] is not None:
                    h["ev"][1].synchronize()
                    t_search += h["ev"][0].elapsed_time(h["ev"][1]) / 1e3
                else:
                    t_search += h["sec"]
                host = {k: v.cpu().numpy() for k, v in res.items()}
                for ks, kd in (("n_work", "work_units"), ("pops", "pops"),
                               ("rank_rows", "rank_rows"),
                               ("frame_rd", "frame_rd_rows"),
                               ("frame_wr", "frame_wr_rows")):
                    counters[kd] += int(host[ks].sum(dtype=np.int64))
                counters["launches"] += 1
                overflow = host["overflow"]
                for r in np.flatnonzero(overflow):
                    failed_p.append(int(sub[cs + r]))
                pending_assembly.append(dict(sub=sub, cs=cs, nb=nb,
                                             res=host, overflow=overflow))

            # one-launch lookahead: dispatch k+1 before collecting k, so
            # per-launch host work overlaps the next launch's device time
            pending: dict | None = None
            for cs in range(0, NQ, Q):
                h = dispatch(cs)
                drain_assembly()
                if pending is not None:
                    collect_h(pending)
                pending = h
            if pending is not None:
                collect_h(pending)
            pass_log.append(dict(B=lanes_p, cap=int(cfg_p.cap),
                                 reads=int(NQ), failed=len(failed_p),
                                 sec=round(_tm.time() - t0p, 2),
                                 work=counters["work_units"] - wk0))
            return failed_p

        def drain_assembly() -> None:
            """Build the Aln lists of every collected launch (Python-side;
            runs while a later launch occupies the device)."""
            while pending_assembly:
                h = pending_assembly.pop(0)
                sub_h, cs, nb = h["sub"], h["cs"], h["nb"]
                res, overflow = h["res"], h["overflow"]
                n_alns = res["n_alns"].tolist()
                oL, oU = res["o_L"].tolist(), res["o_U"].tolist()
                oSc, oLen = res["o_score"].tolist(), res["o_len"].tolist()
                oMM, oGO = res["o_mm"].tolist(), res["o_go"].tolist()
                oGE, oSnp = res["o_ge"].tolist(), res["o_snp"].tolist()
                oPl = res["o_plen"].tolist()
                paths_all = unpack_paths(res["paths"], pathcap)
                sub_l = sub_h[cs:cs + nb].tolist()
                ov_l = overflow.tolist()
                for r in range(nb):
                    if ov_l[r]:
                        continue
                    alns = []
                    for k in range(n_alns[r]):
                        out_len = oLen[r][k]
                        path = _reconstruct_path(paths_all[r, k], oPl[r][k],
                                                 out_len, 0)
                        alns.append(Aln(
                            score=oSc[r][k], L=oL[r][k], U=oU[r][k],
                            num_mm=oMM[r][k], num_gapo=oGO[r][k],
                            num_gape=oGE[r][k], num_snps=oSnp[r][k] & 0xFF,
                            aln_length=out_len, path=path))
                    out[sub_l[r]] = alns

        n_retry = 0
        # Escalation ladder, all rungs continuous-batching: the primary
        # pass at full lanes, then failures re-queue at one deep rung of
        # 128 lanes at the largest per-read budget the same arena memory
        # (cap * lanes) allows.  Reads that out-run even that go to the
        # host gold pool, which has been chewing the pre-routed slice the
        # whole time.
        cell = max(int(cfg.cap) * lanes, 1 << 25)
        failed = ring_pass(order, lanes, cfg, qchunk) if order.size else []
        deep_B = 128
        if failed and deep_B < lanes:
            n_retry += len(failed)
            deep_cfg = dataclasses.replace(
                cfg, cap=min(cell // deep_B, 4 << 20),
                acap=max(cfg.acap, 64))
            sub = np.array(sorted(set(failed)), dtype=np.int64)
            if sort_reads:
                sub = sub[np.argsort(-z[sub], kind="stable")]
            failed = ring_pass(sub, deep_B, deep_cfg, qchunk_p=16)
        if pool is not None and failed:
            pool.submit(sorted(set(failed)))
        drain_assembly()
        if pool is not None:
            n_fallback = pool.submitted
            for orig, alns in pool.drain().items():
                out[orig] = alns
            pool = None
        else:
            rest = sorted(set(failed)) + [int(i) for i in dov_sel]
            n_fallback = len(rest)
            if rest:
                for orig, alns in gold_fallback_many(
                        idx, reads, rest, params,
                        int(params.n_threads)).items():
                    out[orig] = alns
    finally:
        if pool is not None:
            pool.terminate()
    if stats is not None:
        stats.update(fallback_reads=n_fallback, retried_reads=n_retry,
                     prerouted=int(routed.sum()),
                     t_dbounds=round(t_dbounds, 3),
                     t_search=round(t_search, 3),
                     t_host=round(_tm.time() - t_start - t_dbounds
                                  - t_search, 3),
                     tiers=pass_log, **counters)
    return out
