"""Device alignment pipeline: batches reads onto the device search and falls
back to the host gold engine per read on any capacity overflow, so output is
byte-identical to the reference at every capacity setting.

Counterpart of bwbble_tpu/engine/pipeline.py, all of it: the D-bound passes
(device `calc_d_chunk` / `calc_d_1to1_chunk`, the native unbounded-list scanner
and the probe that chooses between them), difficulty ordering and
pre-routing, the fixed-batch tiers (`run_tier`: the default path of
`align`, with its streamed scan-and-launch branch and escalation ladder),
the queued branch with its single deep rung, single-genome `-S` mode in
both, `-P` seeding in both (`precalc`, `seed_slots`), the int64
whole-genome index layout in the fixed tiers, the overlapped host gold
pool, and device meshes (`mesh`, parallel/shard.py: fixed tiers only, no
`-P`, as in the JAX package).

The int64 layout (`didx.idt`, automatic at 2^31 positions) runs as the JAX
package runs it: D bounds, seeds and intervals in int64, fixed tiers only;
a queued run on it raises NotImplementedError, as the JAX package's does.

Where the JAX package chooses a branch by asking whether it runs on its
accelerator, the port takes the accelerator's branch, on the card and on
the CPU alike, because its kernel and its plain version are one function:
the search covers every unsharded run at any lane count, seeded or not, so exact completion runs over lists of 128 intervals in multi-genome
mode (one interval in `-S`), 2.5 % of each D chunk is pre-routed to the
gold pool, the ladder is one deep tier of 256 lanes, and the deep tier is
on whenever the gold pool is up.  Seeded (`-P`) runs keep these rules too,
where the JAX package on its accelerator sends them to its per-iteration
kernel with `kx` slots (no `xcap`) and no deep tier; like the JAX package,
they never take the streamed scan-and-launch branch.  These rules decide
only where a read resolves (device tier, deep tier or gold), never what it
yields, so the `.aln` bytes are the same either way.

With `precalc`, each launch looks its reads' seeds up on the host
(`read_indices` + `lookup_batch`): a read starts from at most `seed_slots`
intervals, and a read with more is flagged over and resolved by the gold
engine, which takes the whole list.

A fixed batch is never padded: a launch gets exactly the reads of its
batch, so no lane and no arena row exists for a read that is not there.
Outside the streamed branch a launch is collected right after its dispatch:
the JAX package's `window` of batches in flight has no counterpart here.

The gold pool (and `gold_fallback_many`) never forks, as the JAX
package's does: a forked child of a process that holds a CUDA context must
not touch it.  Its kind follows from what its workers run
(align/gold_pool.py): threads where they run the native multi-genome gold
engine, which releases the GIL; `spawn`-context processes, which map the
index and the seed table from one shared-memory segment, where they run
the Python gold engine (`-P`, `-S`, no native library), which holds it.
The stats name the kind (`gold_pool`), its workers and their start
seconds.
"""

from __future__ import annotations

import dataclasses
import time as _tm
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from bwbble_tpu_torch import constants as CN
from bwbble_tpu_torch.align.gold_pool import NO_POOL, GoldPool
from bwbble_tpu_torch.align.params import AlnParams
from bwbble_tpu_torch.align.pipeline import align_read_gold
from bwbble_tpu_torch.align.precalc import read_indices
from bwbble_tpu_torch.engine import index_device, kernel
from bwbble_tpu_torch.engine.dbound import calc_d_1to1_chunk, calc_d_chunk
from bwbble_tpu_torch.engine.device_index import DeviceIndex
from bwbble_tpu_torch.engine.inexact import (NB_MAX, OV_LIST, EngineConfig,
                                             QUEUED_I64, inexact_search,
                                             inexact_search_queued,
                                             ring_statics, unpack_paths)
from bwbble_tpu_torch.engine.spans import OFF, Spans
from bwbble_tpu_torch.engine.spans import clock as span_clock
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


def _calc_d_chunk(didx, seq, lengths, lengths_np, params, K):
    """D and D_seed for one padded chunk at interval capacity K; returns
    (D, Ds, overflow) device tensors.  `lengths_np`, a host copy of
    `lengths`, is not read (the JAX package's signature).  On a CUDA index
    a chunk is one launch of a D-bound kernel: calc_d_1to1_chunk for a
    single genome, calc_d_chunk for a multi-genome."""
    dev = didx.device
    seed_len = int(params.seed_length)
    seq = torch.as_tensor(seq).to(dev).to(torch.int8).contiguous()
    lengths = torch.as_tensor(lengths).to(dev).to(torch.int32).contiguous()
    if not params.is_multiref:
        return calc_d_1to1_chunk(didx, seq, lengths, seed_len)
    return calc_d_chunk(didx, seq, lengths, seed_len, K)


def _native_d_ok(didx: DeviceIndex, host_idx: FMIndex | None) -> bool:
    nat = get_native()
    return (host_idx is not None and nat is not None
            and getattr(nat, "_has_calc_d", False)
            and host_idx.length == int(didx.length))


def probe_native_d(didx: DeviceIndex, reads: Reads, params: AlnParams,
                   d_cap: int, k_fast: int = 2,
                   host_idx: FMIndex | None = None,
                   mesh=None, spans: Spans = OFF) -> tuple[int, bool]:
    """(K1, skip): K1 is the device D pass's first-try interval capacity,
    skip=True when the whole device pass should be bypassed for the native
    exact scanner.

    Pure-ACGT references keep lists at width ~1 (k_fast=2 suffices); on
    IUPAC multi-genomes the scan's wide phase carries dozens of disjoint
    intervals on every read, so probe one chunk at k_fast and escalate the
    default width if it overflows.  When even d_cap overflows on >90% of
    the probe chunk, the whole K=d_cap device pass would be discarded
    wholesale for the native scanner, so skip it up front.  Under a `mesh`
    the probe chunk runs through sharded_calc_d_chunk and the native scan
    is never chosen.  `spans`: the call's recorder (`dbounds.probe`, whose
    `kernel` says whether its passes launched a D-bound kernel)."""
    NR = reads.count
    Lmax = max(reads.max_len, 1)
    K1 = min(k_fast, d_cap) if params.is_multiref else d_cap
    if not (params.is_multiref and NR > 0 and d_cap > K1):
        return K1, False
    skip = False
    with spans("dbounds.probe") as span:
        n0 = _d_launches()
        nat_ok = mesh is None and _native_d_ok(didx, host_idx)
        sq = np.zeros((min(256, max(NR, 1)), Lmax), dtype=np.int8)
        nbp = min(256, NR, sq.shape[0])
        sq[:nbp, :reads.seq.shape[1]] = reads.seq[:nbp]
        lnp = np.zeros((sq.shape[0],), dtype=np.int32)
        lnp[:nbp] = reads.lengths[:nbp]
        if mesh is None:
            _, _, dovp = _calc_d_chunk(didx, sq, lnp, lnp, params, K1)
        else:
            from bwbble_tpu_torch.parallel.shard import sharded_calc_d_chunk
            _, _, dovp = sharded_calc_d_chunk(mesh, didx, sq, lnp, params, K1)
        if dovp.cpu().numpy()[:nbp].mean() > 0.5:
            K1 = d_cap
            if nat_ok:
                _, _, dovp2 = _calc_d_chunk(didx, sq, lnp, lnp, params, d_cap)
                skip = bool(dovp2.cpu().numpy()[:nbp].mean() > 0.9)
        span["kernel"] = int(_d_launches() > n0)
    return K1, skip


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
               host_idx: FMIndex | None = None, on_chunk=None, mesh=None,
               spans: Spans = OFF):
    """D/D_seed bounds for every read: one cheap K=k_fast pass (exact unless
    a read's interval list overflows k_fast slots), then a K=d_cap re-run
    for just the overflowing reads, then the native unbounded-list scanner
    for what still overflows.  Returns (D_all, Ds_all device tensors,
    overflow np.bool_[NR] — reads still overflowing).

    `on_chunk(global_idx, z)`: called after each chunk of the first pass
    with the chunk's read indices and difficulty scores, so the caller can
    start routing work (the overlapped gold pool) while later chunks run.
    `mesh`: the device passes run through sharded_calc_d_chunk.
    `spans`: the call's recorder: `dbounds.probe`, a `dbounds.device` span
    a device pass, a `dbounds.native` span a scanned chunk or the serial
    escalation, with a `dbounds.scan` span a scanning thread.

    The reference recomputes these per read with unbounded linked lists
    (calculate_d, inexact_match.c:171-254)."""
    NR = reads.count
    Lmax = max(reads.max_len, 1)
    dev = didx.device
    K1, skip = probe_native_d(didx, reads, params, d_cap, k_fast, host_idx,
                              mesh, spans)
    if skip:
        return _calc_d_native_all(didx, host_idx, reads, params, batch,
                                  on_chunk, spans)
    if mesh is not None:
        from bwbble_tpu_torch.parallel.shard import sharded_calc_d_chunk

        def chunk(sq, ln, K):
            return sharded_calc_d_chunk(mesh, didx, sq, ln, params, K)
    else:
        def chunk(sq, ln, K):
            return _calc_d_chunk(didx, sq, ln, ln, params, K)
    D_parts, Ds_parts, dov_parts = [], [], []
    with spans("dbounds.device", K=K1, reads=NR) as span:
        n0 = _d_launches()
        for s in range(0, NR, batch):
            e = min(s + batch, reads.count)
            nb = e - s
            sq = np.zeros((batch, Lmax), dtype=np.int8)
            sq[:nb, :reads.seq.shape[1]] = reads.seq[s:e]
            ln = np.zeros((batch,), dtype=np.int32)
            ln[:nb] = reads.lengths[s:e]
            D, Ds, dov = chunk(sq, ln, K1)
            D_parts.append(D[:nb])
            Ds_parts.append(Ds[:nb])
            dov_parts.append(dov.cpu().numpy()[:nb])
            if on_chunk is not None:
                on_chunk(np.arange(s, e, dtype=np.int64),
                         _difficulty(D[:nb].cpu().numpy()))
        D_all = torch.cat(D_parts)
        Ds_all = torch.cat(Ds_parts)
        dov_all = np.concatenate(dov_parts)
        span["kernel"] = int(_d_launches() > n0)

    retry = np.flatnonzero(dov_all)
    if retry.size and d_cap > K1:
        dov_all = np.zeros(NR, dtype=bool)
        with spans("dbounds.device", K=d_cap, reads=int(retry.size)) as span:
            n0 = _d_launches()
            for rs in range(0, retry.size, batch):
                sub = retry[rs:rs + batch]
                sel = np.concatenate([sub, np.full(batch - sub.size, sub[0],
                                                   dtype=sub.dtype)])
                sq = np.zeros((batch, Lmax), dtype=np.int8)
                sq[:, :reads.seq.shape[1]] = reads.seq[sel]
                ln = reads.lengths[sel].astype(np.int32)
                D, Ds, dov = chunk(sq, ln, d_cap)
                sidx = torch.from_numpy(sub.astype(np.int64)).to(dev)
                n = sub.size
                D_all[sidx] = D[:n]
                Ds_all[sidx] = Ds[:n]
                dov_all[sub] = dov.cpu().numpy()[:n]
            span["kernel"] = int(_d_launches() > n0)

    # final escalation: reads whose interval lists exceed even d_cap slots
    # get exact D bounds from the native unbounded-list scanner, so D
    # overflow never forces whole-read gold fallback
    still = np.flatnonzero(dov_all)
    if still.size and params.is_multiref and _native_d_ok(didx, host_idx):
        with spans("dbounds.native", threads=1, reads=int(still.size)):
            nat = get_native()
            nb_tab = np.ascontiguousarray(CN.NUCL_BASES, dtype=np.uint8)
            planes = host_idx.bit_planes()
            fused = host_idx.fused_planes()
            seed_len = int(params.seed_length)
            np_dt = _np_dtype(didx)
            Dp = np.zeros((still.size,) + tuple(D_all.shape[1:]),
                          dtype=np_dt)
            Dsp = np.zeros((still.size,) + tuple(Ds_all.shape[1:]),
                           dtype=np_dt)
            w0, c0 = span_clock()
            for t, r in enumerate(still):
                _native_d_read(nat, host_idx, planes, fused, nb_tab,
                               reads.seq[r], int(reads.lengths[r]), seed_len,
                               Dp[t], Dsp[t])
            w1, c1 = span_clock()
            spans.add("dbounds.scan", w0, w1, cpu_ns=c1 - c0)
            sidx = torch.from_numpy(still.astype(np.int64)).to(dev)
            D_all[sidx] = torch.from_numpy(Dp).to(dev)
            Ds_all[sidx] = torch.from_numpy(Dsp).to(dev)
            dov_all[still] = False
    return D_all, Ds_all, dov_all


def _d_launches() -> int:
    """Launches of the D-bound kernels so far (`dbound_1to1`, `dbound_mg`),
    in every layout: a `dbounds.probe` or `dbounds.device` span's `kernel`
    says whether its passes launched one."""
    return sum(v for k, v in kernel.LAUNCHES.items()
               if k.startswith("dbound_"))


def _np_dtype(didx: DeviceIndex):
    """numpy type of D bounds and intervals for the index's layout."""
    return np.int64 if didx.idt == torch.int64 else np.int32


def native_scan_chunks(host_idx: FMIndex, reads: Reads, params: AlnParams,
                       batch: int, np_dt=np.int32, spans: Spans = OFF):
    """Generator: exact D/D_seed bounds from the native unbounded-list
    scanner (the reference's calculate_d semantics at any interval-list
    width, inexact_match.c:171-254), one `batch`-read chunk at a time.
    Yields (indices, D_chunk, Ds_chunk, difficulty); the difficulty proxy
    comes from the exact scanned widths.  With params.n_threads > 1 the
    reads of a chunk are scanned on that many threads (the scanner runs
    with the GIL released and keeps its scratch thread-local).  `spans`: the
    call's recorder: a `dbounds.native` span a chunk, with a `dbounds.scan`
    span a thread (its wall and CPU time), all closed before the yield."""
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
            Dch = np.zeros((e - s, Lmax + 1, 2), dtype=np_dt)
            Dsch = np.zeros((e - s, max(seed_len, 1) + 1, 2), dtype=np_dt)

            def scan(lo, hi, s=s, Dch=Dch, Dsch=Dsch):
                w0, c0 = span_clock()
                for r in range(lo, hi):
                    _native_d_read(nat, host_idx, planes, fused, nb_tab,
                                   reads.seq[r], int(reads.lengths[r]),
                                   seed_len, Dch[r - s], Dsch[r - s])
                w1, c1 = span_clock()
                return w0, w1, c1 - c0

            step = -(-(e - s) // n_threads)
            los = range(s, e, step)
            with spans("dbounds.native", threads=len(los), reads=e - s):
                for f in [ex.submit(scan, lo, min(lo + step, e))
                          for lo in los]:
                    w0, w1, cpu = f.result()
                    spans.add("dbounds.scan", w0, w1, cpu_ns=cpu)
            yield (np.arange(s, e, dtype=np.int64), Dch, Dsch,
                   _difficulty(Dch))


def _calc_d_native_all(didx: DeviceIndex, host_idx: FMIndex, reads: Reads,
                       params: AlnParams, batch: int, on_chunk=None,
                       spans: Spans = OFF):
    """Materialized native_scan_chunks: exact D bounds for every read, with
    `on_chunk` routing as each chunk lands."""
    NR = reads.count
    Lmax = max(reads.max_len, 1)
    seed_len = int(params.seed_length)
    np_dt = _np_dtype(didx)
    D_np = np.zeros((NR, Lmax + 1, 2), dtype=np_dt)
    Ds_np = np.zeros((NR, max(seed_len, 1) + 1, 2), dtype=np_dt)
    for gi, Dch, Dsch, zc in native_scan_chunks(host_idx, reads, params,
                                                batch, np_dt, spans):
        D_np[gi[0]:gi[-1] + 1] = Dch
        Ds_np[gi[0]:gi[-1] + 1] = Dsch
        if on_chunk is not None:
            on_chunk(gi, zc)
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


_COUNTER_KEYS = (("n_work", "work_units"), ("pops", "pops"),
                 ("rank_rows", "rank_rows"), ("frame_rd", "frame_rd_rows"),
                 ("frame_wr", "frame_wr_rows"), ("root_rd", "root_rows"))


def _count_launch(counters: dict, host: dict) -> None:
    """Add one collected launch's per-read counters to the run's totals,
    and the work units of its busiest lane to `chain_work` (a lane's work
    units are a chain of dependent fetches: the base of a latency bound)."""
    for ks, kd in _COUNTER_KEYS:
        counters[kd] = counters.get(kd, 0) + int(
            host[ks].sum(dtype=np.int64))
    counters["launches"] = counters.get("launches", 0) + 1
    counters["chain_work"] = counters.get("chain_work", 0) + int(
        np.bincount(host["o_lane"], weights=host["n_work"]).max())


def _assemble(host: dict, pathcap: int, root_plen: int) -> list:
    """Per-read `Aln` lists of one collected launch (host arrays of a
    search result dict); None for a read that overflowed.  `root_plen`: the
    all-match path a root carries (precalc_len when seeded, else 0).  Bulk
    .tolist() first: Python-int indexing is far cheaper than per-element
    numpy scalar fetches."""
    n_alns = host["n_alns"].tolist()
    oL, oU = host["o_L"].tolist(), host["o_U"].tolist()
    oSc, oLen = host["o_score"].tolist(), host["o_len"].tolist()
    oMM, oGO = host["o_mm"].tolist(), host["o_go"].tolist()
    oGE, oSnp = host["o_ge"].tolist(), host["o_snp"].tolist()
    oPl = host["o_plen"].tolist()
    paths_all = unpack_paths(host["paths"], pathcap)
    out = []
    for r, over in enumerate(host["overflow"].tolist()):
        if over:
            out.append(None)
            continue
        alns = []
        for k in range(n_alns[r]):
            out_len = oLen[r][k]
            path = _reconstruct_path(paths_all[r, k], oPl[r][k], out_len,
                                     root_plen)
            alns.append(Aln(
                score=oSc[r][k], L=oL[r][k], U=oU[r][k],
                num_mm=oMM[r][k], num_gapo=oGO[r][k],
                num_gape=oGE[r][k], num_snps=oSnp[r][k] & 0xFF,
                aln_length=out_len, path=path))
        out.append(alns)
    return out


def _since(t0_ns: int) -> float:
    """Seconds on the host clock (`time.time_ns`) since `t0_ns`."""
    return (_tm.time_ns() - t0_ns) / 1e9


class _LaunchTimer:
    """Time of one search launch.  On a CUDA device the kernel's wrapper
    sets `events` to two CUDA events that its C launch records on the stream
    right before and after the kernel's launch (engine/kernel.py:_launch),
    so the time is the kernel's own, without the host work of the search
    call; on the CPU it is the host clock (`time_ns`) from construction to
    `stop()`."""

    def __init__(self, dev):
        self._cuda = dev.type == "cuda"
        self.events = None
        self._t0 = _tm.time_ns()
        self._sec = 0.0

    def stop(self) -> None:
        self._sec = _since(self._t0)

    def seconds(self) -> float:
        """Blocks until the launch has finished."""
        if not self._cuda:
            return self._sec
        if self.events is None:
            raise RuntimeError("a search launch on a CUDA device recorded "
                               "no events")
        self.events[1].synchronize()
        return self.events[0].elapsed_time(self.events[1]) / 1e3


def _lookup_seeds(precalc, rc: np.ndarray, lengths: np.ndarray,
                  params: AlnParams, seed_slots: int, dev, ids: np.ndarray,
                  seen: np.ndarray, counters: dict, idt=torch.int32):
    """Seed intervals of a launch's reads on the host (read_indices +
    lookup_batch): ((seed_L, seed_U, seed_cnt) tensors on `dev`, the
    intervals in the index's type `idt`, the counts int32; seed_over bool
    [n] — reads with more than `seed_slots` intervals).
    Copies to the device do not wait for it.  The reads `ids` (absolute)
    not `seen` before are added to the counters `no_seed_hit_reads` (no
    interval, or an N among their last precalc_len bases) and
    `seed_over_reads`: each counts the reads launched, once."""
    ri = read_indices(rc, lengths, k=int(params.precalc_len))
    sL, sU, scnt, seed_over = precalc.lookup_batch(ri, int(seed_slots))
    new = ~seen[ids]
    seen[ids] = True
    counters["no_seed_hit_reads"] += int((scnt[new] == 0).sum())
    counters["seed_over_reads"] += int(seed_over[new].sum())
    seeds = tuple(torch.from_numpy(np.ascontiguousarray(x)).to(dev).to(dt)
                  for x, dt in ((sL, idt), (sU, idt), (scnt, torch.int32)))
    return seeds, seed_over


def deep_tier_cfg(base: EngineConfig, B: int, deep_B: int,
                  deep_kx: int) -> EngineConfig:
    """The deep tier's capacities after a first tier of `B` lanes: the
    per-read frame budget rises as the lane count shrinks at constant arena
    rows (cap * lanes)."""
    cell = max(int(base.cap) * B, 1 << 25)
    deep_cap = min(cell // deep_B, 4 << 20)
    return dataclasses.replace(
        base, cap=deep_cap, acap=max(base.acap, 64),
        kx=max(base.kx, deep_kx),
        max_iters=max(base.max_iters, deep_cap // 23 + 1024))


LADDER = ((256, 2),)      # (lanes, kx) of each deep tier
# the JAX package's ladder for its XLA body, which serves tp > 1 meshes
# (here: of CPU devices)
BODY_LADDER = ((1024, 8), (256, 8), (64, 16))


def align_reads_device(idx: FMIndex, didx: DeviceIndex, reads: Reads,
                       params: AlnParams, cfg: EngineConfig | None = None,
                       d_cap: int = 32, stats: dict | None = None,
                       precalc=None, seed_slots: int = 32,
                       sort_reads: bool = True,
                       queued: bool = False, qchunk: int = 2, mesh=None,
                       deep_tiers: bool | None = None,
                       gold_overlap: bool | None = None,
                       device=None) -> list[list[Aln]]:
    """Align all reads on the device; returns per-read alignment lists in
    the reference's discovery order (byte-parity with align_reads_inexact).

    `precalc`: an align.precalc.PrecalcTable for `-P` seeding
    (inexact_match.c:50-57), given exactly when params.use_precalc is set;
    reads whose seed list exceeds `seed_slots` fall back to the host gold
    engine.  `queued`: continuous batching (lanes stream reads from a
    global queue), taken when the read set spans more than one batch;
    bit-identical results.
    `deep_tiers`: force the narrow-lane escalation ladder on/off (None =>
    on when the gold pool is up, else on only without the native gold
    engine).  `gold_overlap`: run the host gold fallback concurrently with
    the device tiers (None => on when the native gold engine is available,
    the run is multi-genome and the read set spans several batches).
    `device`: None means CUDA (raises without one); the index must live
    there.  `mesh`: a parallel.shard.Mesh whose devices are of that type:
    fixed batches, each launch split over its dp members
    (sharded_inexact_search), D bounds through sharded_calc_d_chunk, no
    gold overlap unless asked for; `-P` is refused, as in the JAX package.
    `stats`: a dict the call fills with its counters and, under "spans",
    its spans (engine/spans.py); with None nothing is recorded.
    """
    cfg = cfg or EngineConfig()
    dev = index_device(didx, device)
    if (precalc is not None) != bool(params.use_precalc):
        raise ValueError("a seed table (precalc) goes with "
                         "params.use_precalc, and only with it")
    sp = Spans(stats)
    with sp("align"):
        if not device_params_ok(params, max(reads.max_len, 1)):
            counters = {"fallback_reads": reads.count, "retried_reads": 0,
                        "t_dbounds": 0.0, "gold_routed": True, **NO_POOL}
            out: list = [None] * reads.count
            with sp("gold.drain"):
                for orig, alns in gold_fallback_many(
                        idx, reads, list(range(reads.count)), params,
                        precalc, int(params.n_threads), counters).items():
                    out[orig] = alns
            if stats is not None:
                stats.update(counters)
            return out
        if mesh is not None:
            # the mesh path (dp reads x tp index shards) is the fixed-batch
            # pipeline with the sharded search; results are byte-identical
            # to one device's
            if precalc is not None:
                raise NotImplementedError(
                    "--mesh with -P seeding not yet wired")
            queued = False
        if queued and reads.count > int(params.batch_size):
            if didx.idt == torch.int64:
                raise NotImplementedError(QUEUED_I64)
            return _align_queued(idx, didx, reads, params, cfg, d_cap, stats,
                                 precalc, seed_slots, sort_reads, sp,
                                 qchunk=qchunk)
        return _align_fixed(idx, didx, reads, params, cfg, d_cap, stats,
                            precalc, seed_slots, sort_reads, mesh,
                            deep_tiers, gold_overlap, dev, sp)


def _align_fixed(idx, didx, reads: Reads, params: AlnParams,
                 cfg: EngineConfig, d_cap: int, stats, precalc,
                 seed_slots: int, sort_reads: bool, mesh, deep_tiers,
                 gold_overlap, dev, sp: Spans) -> list:
    """Fixed batches (`run_tier`), with the streamed scan-and-launch
    branch and the escalation ladder: the default path of `align`."""
    t_start = _tm.time_ns()
    B = int(params.batch_size)
    Lmax = max(reads.max_len, 1)
    root_plen = int(params.precalc_len) if precalc is not None else 0
    counters = {"fallback_reads": 0, "retried_reads": 0, **NO_POOL}
    seed_seen = np.zeros(reads.count, dtype=bool)
    if precalc is not None:
        counters.update(no_seed_hit_reads=0, seed_over_reads=0)
    results: list = [None] * reads.count
    fail_why: dict[int, int] = {}   # overflow reason bits per failed read
    work_seen: dict[int, int] = {}  # per-read n_work at failure (tier cap)
    t_launch = [0.0]                # device time of the search launches
    dp = mesh.shape["dp"] if mesh is not None else 1

    def run_tier(sel_all: np.ndarray | None, tier_cfg: EngineConfig,
                 tier_B: int, on_failed=None, sel_gen=None,
                 rung: int = 0) -> list[int]:
        """Process reads[sel_all] with tier_cfg in batches of tier_B; fill
        `results` for resolved reads, return the original indices that
        overflowed.  `on_failed` (streaming gold overlap): called with each
        launch's overflow list as soon as it is known, while later launches
        still run.  `sel_gen` (scan+launch overlap): an iterator of launch
        index arrays pulled BETWEEN a launch's dispatch, which does not
        wait for the device, and its blocking collect, so host work inside
        the iterator (the native D scan) runs while the device searches.
        `rung`: 0 for the first pass, 1 and up for each deep tier; the
        `tier` span carries it beside its lanes, its reads and whether it
        streamed."""
        failed: list[int] = []
        pathcap = tier_cfg.pathcap or (Lmax + 32)

        def dispatch(sel: np.ndarray) -> dict:
            """Launch one batch.  Nothing here waits for the device."""
            with sp("search.dispatch"):
                rc = np.zeros((sel.shape[0], Lmax), dtype=np.int8)
                rc[:, :reads.rc.shape[1]] = reads.rc[sel]
                lengths = reads.lengths[sel].astype(np.int32)
                seeds, seed_over = None, np.zeros(sel.shape[0], dtype=bool)
                if precalc is not None:
                    seeds, seed_over = _lookup_seeds(
                        precalc, rc, lengths, params, seed_slots, dev, sel,
                        seed_seen, counters, didx.idt)
                if isinstance(D_all, np.ndarray):
                    Dsel = torch.from_numpy(D_all[sel]).to(dev)
                    Dssel = torch.from_numpy(Ds_all[sel]).to(dev)
                else:
                    selj = torch.from_numpy(sel.astype(np.int64)).to(dev)
                    Dsel = D_all.index_select(0, selj)
                    Dssel = Ds_all.index_select(0, selj)
                timers = [_LaunchTimer(dev) for _ in range(dp)]
                kw = {} if seeds is None else dict(
                    seed_L=seeds[0], seed_U=seeds[1], seed_cnt=seeds[2])
                if mesh is None:
                    res = inexact_search(didx, rc, lengths, Dsel, Dssel,
                                         params, tier_cfg, device=dev,
                                         timer=timers[0], **kw)
                else:
                    from bwbble_tpu_torch.parallel.shard import \
                        sharded_inexact_search
                    res = sharded_inexact_search(mesh, didx, rc, lengths,
                                                 Dsel, Dssel, params,
                                                 tier_cfg, timers=timers)
                for timer in timers:
                    timer.stop()
                # the pipeline reads the packed paths; the arena goes back to
                # the allocator here, and the next launch on this stream may
                # take the same memory once this one has finished
                del res["arena"]
                return dict(sel=sel, res=res, timers=timers,
                            seed_over=seed_over)

        def collect(h: dict) -> None:
            with sp("search.collect"):
                # a launch over a mesh takes as long as its slowest member
                t_launch[0] += max(t.seconds() for t in h["timers"])
                host = {k: v.cpu().numpy() for k, v in h["res"].items()}
                _count_launch(counters, host)
            # a read with more seeds than slots was searched on a part of
            # its list: its result stands for nothing
            host["overflow"] = host["overflow"] | h["seed_over"]
            sel = h["sel"]
            launch_failed: list[int] = []
            with sp("assemble"):
                for b, alns in enumerate(_assemble(host, pathcap,
                                                   root_plen)):
                    orig = int(sel[b])
                    if alns is None:
                        launch_failed.append(orig)
                        fail_why[orig] = int(host["ovwhy"][b])
                        work_seen[orig] = int(host["n_work"][b])
                    else:
                        results[orig] = alns
            failed.extend(launch_failed)
            if on_failed is not None and launch_failed:
                with sp("route"):
                    on_failed(launch_failed)

        with sp("tier", rung=rung, lanes=int(tier_B),
                reads=0 if sel_all is None else int(sel_all.shape[0]),
                streamed=int(sel_gen is not None)) as span:
            if sel_gen is not None:
                # one launch in flight: dispatch launch k, pull the next
                # batch from the iterator (host-side scan), then block on k
                it = iter(sel_gen)
                nxt = next(it, None)
                while nxt is not None:
                    h = dispatch(nxt)
                    nxt = next(it, None)
                    collect(h)
                # every read the scan did not route to gold was launched
                span["reads"] = int(reads.count - routed.sum())
                return failed
            for start in range(0, sel_all.shape[0], tier_B):
                collect(dispatch(sel_all[start:start + tier_B]))
        return failed

    # Overlapped gold fallback: a host worker pool gold-aligns overflowing
    # reads WHILE the device runs.  It is made BEFORE the D pass so that
    # pre-routed reads (below) keep it busy during the D phase;
    # hardest-first tier order then surfaces the remaining overflow early.
    pool: GoldPool | None = None
    if gold_overlap is None:
        nat0 = get_native()
        gold_overlap = (params.is_multiref and nat0 is not None
                        and getattr(nat0, "_has_gold", False)
                        and mesh is None and reads.count > B)
    if gold_overlap:
        with sp("gold.start"):
            pool = GoldPool(idx, reads, params, precalc,
                            n_workers=max(1, int(params.n_threads)))

    # The kernel runs the search on every CUDA index, and on CPU tensors
    # its plain version takes the same settings unless the index is
    # range-sharded: unsharded, each dp member of a mesh at B // dp lanes
    # (it takes any lane count), its table sharded or not.  Exact
    # completion there runs over lists of up to 128 intervals, which cover
    # the IUPAC-dense reads a handful of kx slots would ship to the host; a
    # single genome keeps one interval, so kx slots are the fit there.  A
    # tp > 1 mesh of CPU devices runs the plain body at the settings of
    # the JAX package's XLA body, which serves tp > 1 there: the caller's
    # xcap, that body's ladder and a 3/8 pre-routed share.
    kernel_body = (mesh is None or mesh.shape["tp"] == 1
                   or dev.type == "cuda")
    if kernel_body:
        cfg = dataclasses.replace(cfg, xcap=128 if params.is_multiref else 0)
    ladder = LADDER if kernel_body else BODY_LADDER

    # Pre-route the per-chunk hardest quantile straight to gold as each D
    # chunk lands (keeps the host pool busy during the D phase).
    routed = np.zeros(reads.count, dtype=bool)
    route_frac = 0.0
    if pool is not None and sort_reads:
        route_frac = 0.025 if kernel_body else 0.375

    def _route_chunk(gi: np.ndarray, zc: np.ndarray) -> None:
        k = int(gi.size * route_frac)
        if k <= 0 or gi.size < 64:
            return
        thr = np.partition(zc, -k)[-k]
        sel = gi[zc >= thr]
        with sp("route"):
            routed[sel] = True
            pool.submit(sel)

    try:
        # Streamed scan+launch overlap: when the d_cap probe shows the
        # device D pass would be discarded for the native scanner anyway
        # (IUPAC-dense multi-genomes) and the gold pool is up, the scan
        # runs on the CPU BETWEEN each launch's dispatch and its blocking
        # collect, so the device starts searching after ONE scanned chunk
        # instead of after the full D phase.  Each launch takes the hardest
        # B pending reads (failures surface early).  `t_dbounds` is the
        # sum of the `dbounds` spans: the probe's, then one a scan piece.
        streamed = False
        if (pool is not None and sort_reads and mesh is None
                and precalc is None):
            with sp("dbounds"):
                streamed = probe_native_d(didx, reads, params, d_cap,
                                          host_idx=idx, spans=sp)[1]
        if streamed:
            seed_len = int(params.seed_length)
            np_dt = _np_dtype(didx)
            D_all = np.zeros((reads.count, Lmax + 1, 2), dtype=np_dt)
            Ds_all = np.zeros((reads.count, max(seed_len, 1) + 1, 2),
                              dtype=np_dt)
            z_all = np.zeros(reads.count, dtype=np.int64)

            def _stream_batches():
                # a scan piece runs from a resume to the next yield: the
                # batches it makes are yielded after its span has closed
                pend_i = np.empty(0, dtype=np.int64)
                pend_z = np.empty(0, dtype=np.int64)
                chunks = native_scan_chunks(idx, reads, params, B, np_dt, sp)
                while True:
                    ready = []
                    with sp("dbounds"):
                        got = next(chunks, None)
                        if got is None:
                            rorder = np.argsort(-pend_z, kind="stable")
                            pend_i = pend_i[rorder]
                            break
                        gi, Dch, Dsch, zc = got
                        D_all[gi[0]:gi[-1] + 1] = Dch
                        Ds_all[gi[0]:gi[-1] + 1] = Dsch
                        z_all[gi[0]:gi[-1] + 1] = zc
                        _route_chunk(gi, zc)
                        keep = ~routed[gi]
                        pend_i = np.concatenate([pend_i, gi[keep]])
                        pend_z = np.concatenate([pend_z, zc[keep]])
                        while pend_i.size >= B:
                            topk = np.argpartition(pend_z, -B)[-B:]
                            ready.append(np.sort(pend_i[topk]))
                            m = np.ones(pend_i.size, dtype=bool)
                            m[topk] = False
                            pend_i, pend_z = pend_i[m], pend_z[m]
                    yield from ready
                for s0 in range(0, pend_i.size, B):
                    yield pend_i[s0:s0 + B]

            t0s = _tm.time_ns()
            # primary-tier failures retry on the device's deep tier
            # instead of streaming to the host pool
            failed = run_tier(None, cfg, B, sel_gen=_stream_batches())
            counters["prerouted"] = int(routed.sum())
            counters["streamed"] = True
            counters["t_dbounds"] = round(sp.seconds("dbounds"), 3)
            counters["tiers"] = [dict(
                B=B, cap=int(cfg.cap), reads=int(reads.count - routed.sum()),
                failed=len(set(failed)), sec=round(_since(t0s), 2))]
            if failed:
                # interval-list overflows go to gold (a deeper arena does
                # not widen the list); everything else retries on the deep
                # tier
                with sp("route"):
                    kx_bound = [r for r in set(failed)
                                if fail_why.get(r, 0) & OV_LIST]
                    if kx_bound:
                        pool.submit(sorted(kx_bound))
                    failed = [r for r in set(failed)
                              if not (fail_why.get(r, 0) & OV_LIST)]
                    # the measured-hardest slice (n_work at the tier cap is
                    # a lower bound on remaining work) goes to the host
                    # pool, which chews it while the deep tier runs; stay
                    # inside the 5% fallback budget overall
                    budget = max(int(0.045 * reads.count) - pool.submitted,
                                 0)
                    hardest = sorted(failed, key=lambda r: (
                        -z_all[r], -work_seen.get(r, 0)))
                    to_gold = hardest[:min(budget, len(failed) // 4)]
                    if to_gold:
                        pool.submit(to_gold)
                    failed = hardest[len(to_gold):]
                for rung, (deep_B, deep_kx) in enumerate(ladder, 1):
                    if not failed:
                        break
                    sel_d = np.array(failed, dtype=np.int64)
                    deep_cfg = deep_tier_cfg(cfg, B, deep_B, deep_kx)
                    td0 = _tm.time_ns()
                    counters["retried_reads"] += int(sel_d.size)
                    failed = run_tier(sel_d, deep_cfg, deep_B, rung=rung)
                    counters["tiers"].append(dict(
                        B=deep_B, cap=int(deep_cfg.cap),
                        reads=int(sel_d.size), failed=len(set(failed)),
                        sec=round(_since(td0), 2)))
                if failed:
                    with sp("route"):
                        pool.submit(sorted(set(failed)))
        else:
            with sp("dbounds"):
                D_all, Ds_all, dov_all = calc_d_all(
                    didx, reads, params,
                    batch=max(1, min(B, reads.count)), d_cap=d_cap,
                    host_idx=idx,
                    on_chunk=_route_chunk if route_frac > 0 else None,
                    mesh=mesh, spans=sp)
                # a mesh's D bounds are joined on `dev`: its sync waits for
                # all
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
            counters["t_dbounds"] = round(sp.seconds("dbounds"), 3)
            counters["prerouted"] = int(routed.sum())
            with sp("route"):
                order = np.flatnonzero(~dov_all & ~routed).astype(np.int64)
                if sort_reads and reads.count > B and order.size:
                    z = difficulty_scores(D_all)
                    order = order[np.argsort(z[order], kind="stable")]
                if pool is not None:
                    if deep_tiers is None:
                        deep_tiers = True
                    if sort_reads:
                        order = order[::-1]
                    dov_sel = np.flatnonzero(dov_all & ~routed)
                    if dov_sel.size:
                        pool.submit(dov_sel)
            if deep_tiers is None:
                # with the native gold engine and no pool (a read set of
                # one batch) hard reads go straight to gold; without it
                # the deep tier beats the Python gold engine by far
                nat = get_native()
                deep_tiers = not (params.is_multiref and nat is not None
                                  and getattr(nat, "_has_gold", False))

            # Escalation ladder: a read's frame budget is NFRAME ~= cap /
            # NSLOT pops, so its on-device budget rises as the lane count
            # shrinks at constant arena memory.  Hard reads (repeat regions
            # can need 10^4-10^5 pops; the reference allows max_entries =
            # 3e6, inexact_match.c:299) ladder down to a narrow deep tier
            # instead of storming the host gold engine.
            tiers: list[tuple[int, EngineConfig]] = [(B, cfg)]
            for deep_B, deep_kx in (ladder if deep_tiers else ()):
                if deep_B < B:
                    tiers.append((deep_B,
                                  deep_tier_cfg(cfg, B, deep_B, deep_kx)))

            tier_log: list[dict] = []
            sel = order
            for t, (tier_B_max, tier_cfg) in enumerate(tiers):
                if sel.shape[0] == 0:
                    break
                if t > 0:
                    counters["retried_reads"] += sel.shape[0]
                t0 = _tm.time_ns()
                stream = (pool.submit if pool is not None
                          and t == len(tiers) - 1 else None)
                tier_B = min(tier_B_max, sel.shape[0])
                failed = run_tier(sel, tier_cfg, tier_B, on_failed=stream,
                                  rung=t)
                tier_log.append(dict(
                    B=int(tier_B), cap=int(tier_cfg.cap),
                    reads=int(sel.shape[0]), failed=len(set(failed)),
                    sec=round(_since(t0), 2)))
                sel = np.array(sorted(set(failed)), dtype=np.int64)
            counters["tiers"] = tier_log
            if pool is None:
                sel = np.concatenate(
                    [sel, np.flatnonzero(dov_all).astype(np.int64)])
                if sel.size:
                    counters["fallback_reads"] += int(sel.size)
                    with sp("gold.drain"):
                        for orig, alns in gold_fallback_many(
                                idx, reads, [int(i) for i in sel], params,
                                precalc, int(params.n_threads),
                                counters).items():
                            results[orig] = alns

        if pool is not None:
            # overflowing reads were submitted as they surfaced; just wait
            # for the workers
            counters["fallback_reads"] += pool.submitted
            with sp("gold.drain"):
                for orig, alns in pool.drain().items():
                    results[orig] = alns
            counters.update(pool.stats())
            pool = None
    finally:
        if pool is not None:
            pool.terminate()
    counters["t_search"] = t_launch[0]
    # in the streamed branch the D scan and the launches overlap, so the
    # parts can add up to more than the wall time
    counters["t_host"] = round(max(_since(t_start) - counters["t_dbounds"]
                                   - t_launch[0], 0.0), 3)
    if stats is not None:
        stats.update(counters)
    return results


def gold_fallback_many(idx, reads: Reads, sel: list[int], params: AlnParams,
                       precalc, n_threads: int,
                       stats: dict | None = None) -> dict[int, list]:
    """Gold-align reads[sel] (`precalc`: the `-P` seed table or None); with
    n_threads > 1 a GoldPool of that many workers (threads or spawned
    processes, by what they run) spreads the reads so overflow storms
    degrade gracefully.  `stats` gets the pool's kind, workers and start
    seconds when one ran."""
    if n_threads <= 1 or len(sel) <= 1:
        return {i: _fb_single(idx, reads, i, params, precalc) for i in sel}
    pool = GoldPool(idx, reads, params, precalc,
                    min(int(n_threads), len(sel)))
    try:
        pool.submit(sel)
        out = pool.drain()
    finally:
        pool.terminate()
    if stats is not None:
        stats.update(pool.stats())
    return out


def _fb_single(idx, reads, i, params, precalc):
    return align_read_gold(idx, reads.seq[i], reads.rc[i],
                           int(reads.lengths[i]), params, precalc=precalc)


def _align_queued(idx, didx, reads: Reads, params: AlnParams,
                  cfg: EngineConfig, d_cap: int, stats, precalc,
                  seed_slots: int, sort_reads: bool, sp: Spans,
                  qchunk: int = 16) -> list:
    """Continuous batching: engine launches stream reads through a fixed
    set of lanes (hardest reads first — LPT scheduling).

    Every read gets a full cfg.cap frame budget of its own, and parent
    chains are walked when a read finishes, so one launch can stream
    arbitrarily many reads; qchunk*lanes reads go into one launch.  Reads
    that overflow their per-read budget retry at a deep rung of fewer
    lanes and a larger budget, and only persistent failures reach the host
    gold engine.  `sp`: the call's recorder.
    """
    t_start = _tm.time_ns()
    NR = reads.count
    dev = didx.device
    lanes = int(params.batch_size)      # the caller sends NR > batch_size
    root_plen = int(params.precalc_len) if precalc is not None else 0
    nseed = int(seed_slots) if precalc is not None else 0
    # exact completion over lists of up to 128 intervals: covers the
    # IUPAC-dense reads a handful of kx slots would ship to the host (a
    # single genome keeps one interval: the caller's xcap stays)
    if params.is_multiref:
        cfg = dataclasses.replace(cfg, xcap=128)

    # overlapped host-gold pool, made before the D pass so pre-routed
    # reads keep the host busy while the device searches
    pool: GoldPool | None = None
    pool_stats = dict(NO_POOL)
    nat = get_native()
    if (params.is_multiref and nat is not None
            and getattr(nat, "_has_gold", False) and NR > lanes):
        with sp("gold.start"):
            pool = GoldPool(idx, reads, params, precalc,
                            n_workers=max(1, int(params.n_threads)))

    try:
        # one forward D pass: search bounds + difficulty ordering
        with sp("dbounds"):
            Dr_all, Dsr_all, dov_raw = calc_d_all(
                didx, reads, params, batch=lanes,
                d_cap=d_cap, host_idx=idx, spans=sp)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        t_dbounds = sp.seconds("dbounds")
        with sp("route"):
            z = difficulty_scores(Dr_all)
            if sort_reads:
                order = np.argsort(-z, kind="stable").astype(np.int64)
            else:
                order = np.arange(NR, dtype=np.int64)

            # Routing budget, derived from a <5% fallback target (4.5%
            # leaves margin): the proxy's hardest reads are the ones that
            # would burn the deepest ring budgets, and the ladder resolves
            # everything else on the device, so the pre-routed slice is the
            # fallback set.
            budget = (int(0.045 * NR) if (pool is not None and sort_reads)
                      else 0)
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
        counters = {kd: 0 for _ks, kd in _COUNTER_KEYS}
        counters["launches"] = 0
        seed_seen = np.zeros(NR, dtype=bool)
        if precalc is not None:
            counters.update(no_seed_hit_reads=0, seed_over_reads=0)
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
            len_s = reads.lengths[sub].astype(np.int32)
            len_d = torch.from_numpy(len_s).to(dev)
            seeds_s, seed_over = None, np.zeros(NQ, dtype=bool)
            if precalc is not None:
                seeds_s, seed_over = _lookup_seeds(
                    precalc, rc_s, len_s, params, seed_slots, dev, sub,
                    seed_seen, counters)
            subj = torch.from_numpy(sub.astype(np.int64)).to(dev)
            D_s = Dr_all.index_select(0, subj)
            Ds_s = Dsr_all.index_select(0, subj)
            nframe = ring_statics(params, cfg_p, Lmax, 2,
                                  seed_slots=nseed).NFRAME
            Q = max(1, int(qchunk_p)) * lanes_p
            # a read's work bound must not bind before its ring budget
            need = (int(qchunk_p) + 2) * nframe + 4096
            cfg_r = dataclasses.replace(
                cfg_p, max_iters=max(int(cfg_p.max_iters), need))
            t0p = _tm.time_ns()
            wk0 = counters["work_units"]
            failed_p: list[int] = []

            def dispatch(cs: int) -> dict:
                with sp("search.dispatch"):
                    ce = min(cs + Q, NQ)
                    kw = {} if seeds_s is None else dict(
                        seed_L=seeds_s[0][cs:ce], seed_U=seeds_s[1][cs:ce],
                        seed_cnt=seeds_s[2][cs:ce])
                    timer = _LaunchTimer(dev)
                    res = inexact_search_queued(
                        didx, rc_d[cs:ce], len_d[cs:ce], D_s[cs:ce],
                        Ds_s[cs:ce], params, cfg_r, lanes=lanes_p,
                        device=dev, timer=timer, **kw)
                    timer.stop()
                    return dict(cs=cs, nb=ce - cs, res=res, timer=timer)

            def collect_h(h: dict) -> None:
                """Block on the launch and extract the cheap outputs
                (failed ids, counters); the Python-side Aln assembly is
                deferred so it can run while the next launch computes."""
                nonlocal t_search
                with sp("search.collect"):
                    cs, nb, res = h["cs"], h["nb"], h["res"]
                    t_search += h["timer"].seconds()
                    host = {k: v.cpu().numpy() for k, v in res.items()}
                    _count_launch(counters, host)
                    host["overflow"] = (host["overflow"]
                                        | seed_over[cs:cs + nb])
                    for r in np.flatnonzero(host["overflow"]):
                        failed_p.append(int(sub[cs + r]))
                    pending_assembly.append(dict(sub=sub, cs=cs, nb=nb,
                                                 res=host))

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
                                 sec=round(_since(t0p), 2),
                                 work=counters["work_units"] - wk0))
            return failed_p

        def drain_assembly() -> None:
            """Build the Aln lists of every collected launch (Python-side;
            runs while a later launch occupies the device)."""
            if not pending_assembly:
                return
            with sp("assemble"):
                while pending_assembly:
                    h = pending_assembly.pop(0)
                    sub_l = h["sub"][h["cs"]:h["cs"] + h["nb"]].tolist()
                    for r, alns in enumerate(_assemble(h["res"], pathcap,
                                                       root_plen)):
                        if alns is not None:
                            out[sub_l[r]] = alns

        n_retry = 0
        # Escalation ladder, all rungs continuous-batching: the primary
        # pass at full lanes, then failures re-queue at one deep rung of
        # 128 lanes at the largest per-read budget the same arena memory
        # (cap * lanes) allows.  Reads that out-run even that go to the
        # host gold pool, which has been chewing the pre-routed slice the
        # whole time.
        cell = max(int(cfg.cap) * lanes, 1 << 25)
        failed = []
        if order.size:
            with sp("tier", rung=0, lanes=lanes, reads=int(order.size),
                    streamed=0):
                failed = ring_pass(order, lanes, cfg, qchunk)
        deep_B = 128
        if failed and deep_B < lanes:
            n_retry += len(failed)
            deep_cfg = dataclasses.replace(
                cfg, cap=min(cell // deep_B, 4 << 20),
                acap=max(cfg.acap, 64))
            sub = np.array(sorted(set(failed)), dtype=np.int64)
            if sort_reads:
                sub = sub[np.argsort(-z[sub], kind="stable")]
            with sp("tier", rung=1, lanes=deep_B, reads=int(sub.size),
                    streamed=0):
                failed = ring_pass(sub, deep_B, deep_cfg, qchunk_p=16)
        if pool is not None and failed:
            with sp("route"):
                pool.submit(sorted(set(failed)))
        drain_assembly()
        if pool is not None:
            n_fallback = pool.submitted
            with sp("gold.drain"):
                for orig, alns in pool.drain().items():
                    out[orig] = alns
            pool_stats = pool.stats()
            pool = None
        else:
            rest = sorted(set(failed)) + [int(i) for i in dov_sel]
            n_fallback = len(rest)
            if rest:
                with sp("gold.drain"):
                    for orig, alns in gold_fallback_many(
                            idx, reads, rest, params, precalc,
                            int(params.n_threads), pool_stats).items():
                        out[orig] = alns
    finally:
        if pool is not None:
            pool.terminate()
    if stats is not None:
        stats.update(fallback_reads=n_fallback, retried_reads=n_retry,
                     prerouted=int(routed.sum()),
                     t_dbounds=round(t_dbounds, 3),
                     t_search=t_search,
                     t_host=round(_since(t_start) - t_dbounds - t_search, 3),
                     tiers=pass_log, **pool_stats, **counters)
    return out
