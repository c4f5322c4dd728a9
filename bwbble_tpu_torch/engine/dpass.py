"""The D-bound pass of an alignment call: D and D_seed, the lower bounds the
search prunes with, for every read, and the difficulty order they give.

Counterpart of the D-bound part of bwbble_tpu/engine/pipeline.py: the probe
that chooses between the device pass and the native scanner, the device
pass chunk by chunk (one launch of a D-bound kernel a chunk on a CUDA
index, engine/dbound.py), the native unbounded-list scanner (threaded, a
chunk at a time), and the difficulty proxy.  A call on a mesh hands the
mesh in: its `chunk_bounds` runs a chunk over the mesh's members
(parallel/shard.py), and the native scanner is never chosen there.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from bwbble_tpu_torch import constants as CN
from bwbble_tpu_torch.align.params import AlnParams
from bwbble_tpu_torch.engine import kernel
from bwbble_tpu_torch.engine.dbound import calc_d_1to1_chunk, calc_d_chunk
from bwbble_tpu_torch.engine.device_index import DeviceIndex
from bwbble_tpu_torch.engine.spans import OFF, Spans
from bwbble_tpu_torch.engine.spans import clock as span_clock
from bwbble_tpu_torch.formats.fastq import Reads
from bwbble_tpu_torch.index.fmindex import FMIndex
from bwbble_tpu_torch.native import get_native


def chunk_bounds(didx, seq, lengths, params, K):
    """D and D_seed for one padded chunk at interval capacity K; returns
    (D, Ds, overflow) device tensors.  On a CUDA index a chunk is one
    launch of a D-bound kernel: calc_d_1to1_chunk for a single genome,
    calc_d_chunk for a multi-genome."""
    dev = didx.device
    seed_len = int(params.seed_length)
    seq = torch.as_tensor(seq).to(dev).to(torch.int8).contiguous()
    lengths = torch.as_tensor(lengths).to(dev).to(torch.int32).contiguous()
    if not params.is_multiref:
        return calc_d_1to1_chunk(didx, seq, lengths, seed_len)
    return calc_d_chunk(didx, seq, lengths, seed_len, K)


def _chunk_fn(mesh):
    """The chunk pass of a call: over its mesh, or on its one device."""
    return chunk_bounds if mesh is None else mesh.chunk_bounds


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
    the probe chunk runs over the mesh and the native scan is never
    chosen.  `spans`: the call's recorder (`dbounds.probe`, whose `kernel`
    says whether its passes launched a D-bound kernel)."""
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
        _, _, dovp = _chunk_fn(mesh)(didx, sq, lnp, params, K1)
        if dovp.cpu().numpy()[:nbp].mean() > 0.5:
            K1 = d_cap
            if nat_ok:
                _, _, dovp2 = chunk_bounds(didx, sq, lnp, params, d_cap)
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
               batch: int, verdict: tuple[int, bool], d_cap: int = 16,
               host_idx: FMIndex | None = None, on_chunk=None, mesh=None,
               spans: Spans = OFF):
    """D/D_seed bounds for every read, after `verdict`, probe_native_d's
    (K1, skip) for this call: with skip the native scanner takes every
    read; else one cheap K=K1 pass (exact unless a read's interval list
    overflows K1 slots), then a K=d_cap re-run for just the overflowing
    reads, then the native unbounded-list scanner for what still
    overflows.  Returns (D_all, Ds_all device tensors, overflow np.bool_[NR]
    — reads still overflowing).

    `on_chunk(global_idx, z)`: called after each chunk of the first pass
    with the chunk's read indices and difficulty scores, so the caller can
    start routing work (the overlapped gold pool) while later chunks run.
    `mesh`: the device passes run over it.  `spans`: the call's recorder:
    a `dbounds.device` span a device pass, a `dbounds.native` span a
    scanned chunk or the serial escalation, with a `dbounds.scan` span a
    scanning thread.

    The reference recomputes these per read with unbounded linked lists
    (calculate_d, inexact_match.c:171-254)."""
    NR = reads.count
    Lmax = max(reads.max_len, 1)
    dev = didx.device
    K1, skip = verdict
    if skip:
        return _calc_d_native_all(didx, host_idx, reads, params, batch,
                                  on_chunk, spans)
    chunk = _chunk_fn(mesh)
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
            D, Ds, dov = chunk(didx, sq, ln, params, K1)
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
                D, Ds, dov = chunk(didx, sq, ln, params, d_cap)
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
            np_dt = np_dtype(didx)
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


def np_dtype(didx: DeviceIndex):
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
    np_dt = np_dtype(didx)
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
