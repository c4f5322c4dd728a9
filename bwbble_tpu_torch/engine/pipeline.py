"""Device alignment pipeline: batches reads onto the device search and falls
back to the host gold engine per read on any capacity overflow, so output is
byte-identical to the reference at every capacity setting.

Counterpart of bwbble_tpu/engine/pipeline.py but for its D-bound pass
(engine/dpass.py, below this module): difficulty ordering and pre-routing,
the fixed-batch tiers (`_fixed`: the default path of `align`, with its
streamed scan-and-launch branch and escalation ladder), the queued branch
with its single deep rung (`_queued`), `-S` and `-P` in both, the int64
layout in the fixed tiers (a queued run on it raises NotImplementedError,
as the JAX package's does), the overlapped host gold pool, and device
meshes (`mesh`, parallel/shard.py: fixed tiers only, no `-P`, as in the
JAX package).  Every branch runs its launches through one cycle (`_Call`:
stage, dispatch, collect, assemble) and ends in one gold step
(`_gold_finish`).

Where the JAX package chooses a branch by asking whether it runs on its
accelerator, the port takes the accelerator's branch everywhere, because
its kernel and its plain version are one function covering every run (any
lane count, seeded or not, on one device or a mesh): exact completion runs
over lists of 128 intervals in multi-genome mode (one interval in `-S`),
2.5 % of each D chunk is pre-routed to the gold pool, the ladder is one
deep tier of 256 lanes, and the deep tier is on whenever the gold pool is
up.  Seeded (`-P`) runs keep these rules too and, as in the JAX package,
never take the streamed branch.  These rules decide only where a read
resolves (device tier, deep tier or gold), never what it yields, so the
`.aln` bytes are the same either way.

A fixed batch is never padded: a launch gets exactly the reads of its
batch.  Outside the streamed branch a fixed launch is collected right after
its dispatch (the JAX package's `window` has no counterpart here).

The gold pool (and `gold_fallback_many`) never forks: a forked child of a
process that holds a CUDA context must not touch it.  Its workers are
threads where they run the native multi-genome gold engine, which releases
the GIL, and `spawn`-context processes mapping the index and the seed table
from one shared-memory segment where they run the Python gold engine
(`-P`, `-S`, no native library; align/gold_pool.py).  The stats name its
kind (`gold_pool`), its workers and their start seconds.
"""

from __future__ import annotations

import dataclasses
import time as _tm

import numpy as np
import torch

from bwbble_tpu_torch.align.gold_pool import NO_POOL, GoldPool
from bwbble_tpu_torch.align.params import AlnParams
from bwbble_tpu_torch.align.pipeline import align_read_gold
from bwbble_tpu_torch.align.precalc import read_indices
from bwbble_tpu_torch.engine import index_device
from bwbble_tpu_torch.engine.device_index import DeviceIndex
from bwbble_tpu_torch.engine.dpass import (calc_d_all, difficulty_scores,
                                           native_scan_chunks, np_dtype,
                                           probe_native_d)
from bwbble_tpu_torch.engine.inexact import (NB_MAX, OV_LIST, EngineConfig,
                                             QUEUED_I64, inexact_search,
                                             inexact_search_queued,
                                             ring_statics, unpack_paths)
from bwbble_tpu_torch.engine.spans import Spans
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
        counters[kd] += int(host[ks].sum(dtype=np.int64))
    counters["launches"] += 1
    counters["chain_work"] += int(
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
    """A deep tier's capacities after a first tier of `B` lanes: the
    per-read frame budget rises as the lane count shrinks at constant arena
    rows (cap * lanes)."""
    cell = max(int(base.cap) * B, 1 << 25)
    deep_cap = min(cell // deep_B, 4 << 20)
    return dataclasses.replace(
        base, cap=deep_cap, acap=max(base.acap, 64),
        kx=max(base.kx, deep_kx),
        max_iters=max(base.max_iters, deep_cap // 23 + 1024))


LADDER = ((256, 2),)      # (lanes, kx) of each deep tier of the fixed path
RING_RUNG = 128           # lanes of the queued deep rung (the caller's kx)
# Share of a call's reads the gold engine may take on purpose, from a <5 %
# fallback target (4.5 % leaves margin)
GOLD_SHARE = 0.045


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
    `deep_tiers`: force the fixed path's narrow-lane escalation ladder
    on/off (None => on when the gold pool is up, else on only without the
    native gold engine).  `gold_overlap`: run the host gold fallback
    concurrently with the device tiers (None => on when the native gold
    engine is available, the run is multi-genome, on one device, and the
    read set spans several batches).
    `device`: None means CUDA (raises without one); the index must live
    there.  `mesh`: a parallel.shard.Mesh whose devices are of that type:
    fixed batches, each launch split over its dp members (its
    `inexact_search`), D bounds through its `chunk_bounds`; `-P` is
    refused, as in the JAX package.
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
            counters = {"fallback_reads": 0, "retried_reads": 0,
                        "t_dbounds": 0.0, "gold_routed": True, **NO_POOL}
            out: list = [None] * reads.count
            _gold_finish(idx, reads, params, precalc, None,
                         list(range(reads.count)), out, counters, sp)
            if stats is not None:
                stats.update(counters)
            return out
        if mesh is not None and precalc is not None:
            raise NotImplementedError("--mesh with -P seeding not yet wired")
        # a mesh runs the fixed-batch pipeline with the sharded search (dp
        # reads x tp index shards): results are byte-identical to one
        # device's
        queued = (queued and mesh is None
                  and reads.count > int(params.batch_size))
        if queued and didx.idt == torch.int64:
            raise NotImplementedError(QUEUED_I64)
        # exact completion over lists of up to 128 intervals covers the
        # IUPAC-dense reads a few kx slots would ship to the host (-S: kx)
        cfg = dataclasses.replace(cfg, xcap=128 if params.is_multiref else 0)
        call = _Call(idx, didx, reads, params, precalc, seed_slots, dev,
                     mesh, sp, cfg.pathcap)
        # Overlapped gold fallback: a host worker pool gold-aligns reads
        # WHILE the device runs, made BEFORE the D pass so that pre-routed
        # reads keep it busy during the D phase.
        if gold_overlap is None:
            gold_overlap = (params.is_multiref and mesh is None
                            and getattr(get_native(), "_has_gold", False)
                            and reads.count > int(params.batch_size))
        if gold_overlap:
            with sp("gold.start"):
                call.pool = GoldPool(idx, reads, params, precalc,
                                     n_workers=max(1, int(params.n_threads)))
        try:
            rest = (_queued(call, cfg, d_cap, sort_reads, qchunk) if queued
                    else _fixed(call, cfg, d_cap, sort_reads, deep_tiers))
            _gold_finish(idx, reads, params, precalc, call.pool, rest,
                         call.results, call.counters, sp)
        finally:
            if call.pool is not None:
                call.pool.terminate()
        if stats is not None:
            stats.update(call.counters, **call.times())
        return call.results


class _Call:
    """One call's launch cycle and what it fills (results, counters, search
    time): a launch is staged (rc, lengths, seeds, D rows), dispatched (a
    fixed batch, over the mesh where the call has one, or a ring launch),
    collected (its time, result and counters) and assembled."""

    def __init__(self, idx, didx: DeviceIndex, reads: Reads,
                 params: AlnParams, precalc, seed_slots: int, dev, mesh,
                 sp: Spans, pathcap: int):
        self.t_start = _tm.time_ns()
        self.idx, self.didx, self.reads, self.precalc = idx, didx, reads, \
            precalc
        self.params, self.seed_slots = params, int(seed_slots)
        self.dev, self.mesh, self.sp = dev, mesh, sp
        self.dp = mesh.shape["dp"] if mesh is not None else 1
        self.Lmax = max(reads.max_len, 1)
        self.pathcap = pathcap or (self.Lmax + 32)
        self.root_plen = int(params.precalc_len) if precalc is not None \
            else 0
        self.pool: GoldPool | None = None
        self.results: list = [None] * reads.count
        self.routed = np.zeros(reads.count, dtype=bool)  # pre-routed to gold
        self.seed_seen = np.zeros(reads.count, dtype=bool)
        self.D = self.Ds = None     # D rows (host arrays where it streams)
        self.t_search = 0.0
        self.counters: dict = {"fallback_reads": 0, "retried_reads": 0,
                               "launches": 0, "chain_work": 0, "tiers": [],
                               **{kd: 0 for _ks, kd in _COUNTER_KEYS},
                               **NO_POOL}
        if precalc is not None:
            self.counters.update(no_seed_hit_reads=0, seed_over_reads=0)

    def d_pass(self, d_cap: int, on_chunk=None, may_stream: bool = False):
        """The call's D pass, in one `dbounds` span: the probe, then
        calc_d_all on its verdict, unless the probe skips the device pass
        where the caller `may_stream` the native scan instead.  Sets the
        call's D rows and returns the reads whose bounds still overflow, or
        None where the scan is to stream."""
        with self.sp("dbounds"):
            verdict = probe_native_d(self.didx, self.reads, self.params,
                                     d_cap, host_idx=self.idx,
                                     mesh=self.mesh, spans=self.sp)
            if may_stream and verdict[1]:
                return None
            self.D, self.Ds, dov = calc_d_all(
                self.didx, self.reads, self.params,
                max(1, min(int(self.params.batch_size), self.reads.count)),
                verdict, d_cap, host_idx=self.idx, on_chunk=on_chunk,
                mesh=self.mesh, spans=self.sp)
            # a mesh's D bounds are joined on `dev`: its sync waits for all
            if self.dev.type == "cuda":
                torch.cuda.synchronize(self.dev)
        return dov

    def stage(self, sel: np.ndarray, on_device: bool = False) -> dict:
        """The launch inputs of reads[sel]: rc and lengths (host arrays, or
        copied to the device), seeds and seed_over (with `-P`), D rows on
        the device."""
        reads, dev = self.reads, self.dev
        rc = np.zeros((sel.shape[0], self.Lmax), dtype=np.int8)
        rc[:, :reads.rc.shape[1]] = reads.rc[sel]
        lengths = reads.lengths[sel].astype(np.int32)
        seeds, over = None, np.zeros(sel.shape[0], dtype=bool)
        if self.precalc is not None:
            seeds, over = _lookup_seeds(
                self.precalc, rc, lengths, self.params, self.seed_slots, dev,
                sel, self.seed_seen, self.counters, self.didx.idt)
        if isinstance(self.D, np.ndarray):
            D = torch.from_numpy(self.D[sel]).to(dev)
            Ds = torch.from_numpy(self.Ds[sel]).to(dev)
        else:
            selj = torch.from_numpy(sel.astype(np.int64)).to(dev)
            D = self.D.index_select(0, selj)
            Ds = self.Ds.index_select(0, selj)
        if on_device:
            rc, lengths = (torch.from_numpy(x).to(dev) for x in (rc, lengths))
        return dict(rc=rc, lengths=lengths, D=D, Ds=Ds, seeds=seeds,
                    over=over)

    def dispatch(self, cfg: EngineConfig, sel: np.ndarray, lanes: int = 0,
                 staged: dict | None = None, lo: int = 0) -> dict:
        """Launch reads[sel] with `cfg`: a fixed batch, or with `lanes` a
        ring launch whose inputs are rows lo:lo + len(sel) of its pass's
        `staged` ones (None: staged here).  Nothing waits for the
        device."""
        with self.sp("search.dispatch"):
            st = staged if staged is not None else self.stage(sel)
            part = slice(lo, lo + sel.shape[0])
            args = [st[k][part] for k in ("rc", "lengths", "D", "Ds")]
            kw = {} if st["seeds"] is None else dict(zip(
                ("seed_L", "seed_U", "seed_cnt"),
                (x[part] for x in st["seeds"])))
            timers = [_LaunchTimer(self.dev) for _ in range(self.dp)]
            if lanes:
                res = inexact_search_queued(
                    self.didx, *args, self.params, cfg, lanes=lanes,
                    device=self.dev, timer=timers[0], **kw)
            elif self.mesh is None:
                res = inexact_search(self.didx, *args, self.params, cfg,
                                     device=self.dev, timer=timers[0], **kw)
            else:
                res = self.mesh.inexact_search(self.didx, *args, self.params,
                                               cfg, timers=timers)
            for timer in timers:
                timer.stop()
            # the pipeline reads the packed paths; a fixed launch's arena
            # goes back to the allocator here, and the next launch on this
            # stream may take the same memory once this one has finished
            res.pop("arena", None)
            return dict(sel=sel, res=res, timers=timers, over=st["over"][part])

    def collect(self, h: dict) -> dict:
        """Block on a launch: its result's host arrays, `overflow` also set
        for reads over their seed slots, with `sel` (the reads' ids) and
        `failed` (the ids that overflowed)."""
        with self.sp("search.collect"):
            # a launch over a mesh takes as long as its slowest member
            self.t_search += max(t.seconds() for t in h["timers"])
            host = {k: v.cpu().numpy() for k, v in h["res"].items()}
            _count_launch(self.counters, host)
            # a read with more seeds than slots was searched on a part of
            # its list: its result stands for nothing
            host["overflow"] = host["overflow"] | h["over"]
            host["sel"] = h["sel"]
            host["failed"] = h["sel"][host["overflow"]]
        return host

    def assemble(self, hosts: list) -> None:
        """Fill the results of the collected launches `hosts` (emptied) for
        every read that did not overflow, in one `assemble` span."""
        if not hosts:
            return
        with self.sp("assemble"):
            while hosts:
                host = hosts.pop(0)
                ids = host["sel"].tolist()
                for r, alns in enumerate(_assemble(host, self.pathcap,
                                                   self.root_plen)):
                    if alns is not None:
                        self.results[ids[r]] = alns

    def log_tier(self, B: int, cfg: EngineConfig, reads: int, failed: list,
                 t0_ns: int, **extra) -> None:
        self.counters["tiers"].append(dict(
            B=int(B), cap=int(cfg.cap), reads=int(reads),
            failed=len(set(failed)), sec=round(_since(t0_ns), 2), **extra))

    def times(self) -> dict:
        """`t_dbounds` (the `dbounds` spans), `t_search` (the launches'
        own), `t_host` (the rest of the wall time) and `prerouted`."""
        t_dbounds = self.sp.seconds("dbounds")
        # in the streamed branch the D scan and the launches overlap, so
        # the parts can add up to more than the wall time
        return dict(t_dbounds=round(t_dbounds, 3), t_search=self.t_search,
                    t_host=round(max(_since(self.t_start) - t_dbounds
                                     - self.t_search, 0.0), 3),
                    prerouted=int(self.routed.sum()))


def _batches(sel: np.ndarray, B: int):
    return (sel[s:s + B] for s in range(0, sel.shape[0], B))


def _fixed(call: _Call, cfg: EngineConfig, d_cap: int, sort_reads: bool,
           deep_tiers) -> list[int]:
    """Fixed batches (`run_tier`), with the streamed scan-and-launch
    branch and the escalation ladder: the default path of `align`.
    Returns the reads left for the gold engine where no pool took them."""
    reads, params, sp, pool = call.reads, call.params, call.sp, call.pool
    counters, routed = call.counters, call.routed
    NR, B = reads.count, int(params.batch_size)
    fail_why: dict[int, int] = {}   # overflow reason bits per failed read
    work_seen: dict[int, int] = {}  # per-read n_work at failure (tier cap)

    def run_tier(rung: int, tier_cfg: EngineConfig, tier_B: int, batches,
                 on_failed=None, streamed: bool = False) -> list[int]:
        """Launch each batch (index array) of `batches`; return the ids
        that overflowed.  `on_failed` gets each launch's overflow list at
        once, while later launches still run.  The next batch is pulled
        BETWEEN a launch's dispatch and its blocking collect, so host work
        inside a streamed iterator (the native D scan) runs while the
        device searches."""
        failed: list[int] = []
        t0, n = _tm.time_ns(), 0
        with sp("tier", rung=rung, lanes=int(tier_B), reads=0,
                streamed=int(streamed)) as span:
            it = iter(batches)
            nxt = next(it, None)
            while nxt is not None:
                h = call.dispatch(tier_cfg, nxt)
                n += nxt.shape[0]
                nxt = next(it, None)
                host = call.collect(h)
                call.assemble([host])
                bad = host["failed"].tolist()
                for r, why, work in zip(bad,
                                        host["ovwhy"][host["overflow"]],
                                        host["n_work"][host["overflow"]]):
                    fail_why[r], work_seen[r] = int(why), int(work)
                failed.extend(bad)
                if on_failed is not None and bad:
                    with sp("route"):
                        on_failed(bad)
            span["reads"] = n
        call.log_tier(tier_B, tier_cfg, n, failed, t0)
        return failed

    def ladder(sel: np.ndarray, tiers: list, rung0: int, clip: bool,
               on_last=None) -> np.ndarray:
        """Run `tiers` ((lanes, cfg), from rung `rung0`) on `sel`, each on
        the failures of the one before (lanes cut to the reads with `clip`,
        the last one's failures to `on_last`); the last failures, sorted."""
        for rung, (tier_B, tier_cfg) in enumerate(tiers, rung0):
            if sel.shape[0] == 0:
                break
            if rung > 0:
                counters["retried_reads"] += sel.shape[0]
            if clip:
                tier_B = min(tier_B, sel.shape[0])
            failed = run_tier(rung, tier_cfg, tier_B, _batches(sel, tier_B),
                              on_failed=(on_last if rung == rung0
                                         + len(tiers) - 1 else None))
            sel = np.array(sorted(set(failed)), dtype=np.int64)
        return sel

    # Escalation ladder: a read's frame budget is NFRAME ~= cap / NSLOT
    # pops, so its on-device budget rises as the lane count shrinks at
    # constant arena memory.  Hard reads (repeat regions can need 10^4-10^5
    # pops; the reference allows max_entries = 3e6, inexact_match.c:299)
    # ladder down to a narrow deep tier instead of storming the host gold
    # engine.
    deep = [(deep_B, deep_tier_cfg(cfg, B, deep_B, deep_kx))
            for deep_B, deep_kx in LADDER]

    # Pre-route the per-chunk hardest quantile straight to gold as each D
    # chunk lands (keeps the host pool busy during the D phase).
    route_frac = 0.025 if pool is not None and sort_reads else 0.0

    def route_chunk(gi: np.ndarray, zc: np.ndarray) -> None:
        k = int(gi.size * route_frac)
        if k <= 0 or gi.size < 64:
            return
        thr = np.partition(zc, -k)[-k]
        sel = gi[zc >= thr]
        with sp("route"):
            routed[sel] = True
            pool.submit(sel)

    # Streamed scan+launch overlap: when the probe hands the D pass to the
    # native scanner (IUPAC-dense multi-genomes) and the gold pool is up,
    # the scan runs on the CPU BETWEEN each launch's dispatch and its
    # blocking collect, so the device starts searching after ONE scanned
    # chunk.  Each launch takes the hardest B pending reads (failures
    # surface early).  `dbounds` spans: the probe's, then one a scan piece.
    dov = call.d_pass(d_cap, route_chunk if route_frac > 0 else None,
                      may_stream=(pool is not None and sort_reads
                                  and call.mesh is None
                                  and call.precalc is None))
    if dov is None:
        counters["streamed"] = True
        np_dt = np_dtype(call.didx)
        call.D = np.zeros((NR, call.Lmax + 1, 2), dtype=np_dt)
        call.Ds = np.zeros((NR, max(int(params.seed_length), 1) + 1, 2),
                           dtype=np_dt)
        z_all = np.zeros(NR, dtype=np.int64)

        def stream_batches():
            # a scan piece runs from a resume to the next yield: the
            # batches it makes are yielded after its span has closed
            pend_i = np.empty(0, dtype=np.int64)
            pend_z = np.empty(0, dtype=np.int64)
            chunks = native_scan_chunks(call.idx, reads, params, B, np_dt,
                                        sp)
            while True:
                ready = []
                with sp("dbounds"):
                    got = next(chunks, None)
                    if got is None:
                        pend_i = pend_i[np.argsort(-pend_z, kind="stable")]
                        break
                    gi, Dch, Dsch, zc = got
                    call.D[gi[0]:gi[-1] + 1] = Dch
                    call.Ds[gi[0]:gi[-1] + 1] = Dsch
                    z_all[gi[0]:gi[-1] + 1] = zc
                    route_chunk(gi, zc)
                    keep = ~routed[gi]
                    pend_i = np.concatenate([pend_i, gi[keep]])
                    pend_z = np.concatenate([pend_z, zc[keep]])
                    while pend_i.size >= B:
                        topk = np.argpartition(pend_z, -B)[-B:]
                        ready.append(np.sort(pend_i[topk]))
                        pend_i = np.delete(pend_i, topk)
                        pend_z = np.delete(pend_z, topk)
                yield from ready
            yield from _batches(pend_i, B)

        # primary-tier failures retry on the device's deep tier instead of
        # streaming to the host pool
        failed = run_tier(0, cfg, B, stream_batches(), streamed=True)
        if failed:
            # interval-list overflows go to gold (a deeper arena does not
            # widen the list); everything else retries on the deep tier
            with sp("route"):
                pool.submit(sorted(r for r in set(failed)
                                   if fail_why.get(r, 0) & OV_LIST))
                failed = [r for r in set(failed)
                          if not (fail_why.get(r, 0) & OV_LIST)]
                # the measured-hardest slice (n_work at the tier cap is a
                # lower bound on remaining work) goes to the host pool,
                # which chews it while the deep tier runs; stay inside the
                # gold share overall
                budget = max(int(GOLD_SHARE * NR) - pool.submitted, 0)
                hardest = sorted(failed, key=lambda r: (
                    -z_all[r], -work_seen.get(r, 0)))
                to_gold = hardest[:min(budget, len(failed) // 4)]
                pool.submit(to_gold)
            left = ladder(np.array(hardest[len(to_gold):], dtype=np.int64),
                          deep, 1, clip=False)
            if left.size:
                with sp("route"):
                    pool.submit(left)
        return []

    with sp("route"):
        order = np.flatnonzero(~dov & ~routed).astype(np.int64)
        if sort_reads and NR > B and order.size:
            z = difficulty_scores(call.D)
            order = order[np.argsort(z[order], kind="stable")]
        dov_sel = np.flatnonzero(dov & ~routed)
        if pool is not None:
            if sort_reads:
                order = order[::-1]
            pool.submit(dov_sel)
    if deep_tiers is None:
        # on with the gold pool; with the native gold engine and no pool (a
        # read set of one batch) hard reads go straight to gold; without it
        # the deep tier beats the Python gold engine by far
        deep_tiers = pool is not None or not (
            params.is_multiref and getattr(get_native(), "_has_gold", False))
    # the last tier's failures stream to the pool as they surface
    left = ladder(order, [(B, cfg)] + [t for t in deep if deep_tiers
                                        and t[0] < B], 0, clip=True,
                  on_last=None if pool is None else pool.submit)
    return [] if pool is not None else np.concatenate([left,
                                                       dov_sel]).tolist()


def _queued(call: _Call, cfg: EngineConfig, d_cap: int, sort_reads: bool,
            qchunk: int) -> list[int]:
    """Continuous batching: engine launches stream reads through a fixed
    set of lanes (hardest reads first — LPT scheduling).  Every read gets a
    full cfg.cap frame budget of its own, and parent chains are walked when
    a read finishes, so one launch can stream arbitrarily many reads;
    qchunk*lanes reads go into one launch.  Returns the reads left for the
    gold engine where no pool took them."""
    reads, params, sp, pool = call.reads, call.params, call.sp, call.pool
    counters, routed = call.counters, call.routed
    NR = reads.count
    lanes = int(params.batch_size)      # the caller sends NR > batch_size
    nseed = call.seed_slots if call.precalc is not None else 0

    # one forward D pass: search bounds + difficulty ordering
    dov = call.d_pass(d_cap)
    with sp("route"):
        z = difficulty_scores(call.D)
        if sort_reads:
            order = np.argsort(-z, kind="stable").astype(np.int64)
        else:
            order = np.arange(NR, dtype=np.int64)
        # the proxy's hardest reads are the ones that would burn the
        # deepest ring budgets, and the ladder resolves everything else on
        # the device, so the pre-routed gold share is the fallback set
        budget = int(GOLD_SHARE * NR) if (pool is not None
                                          and sort_reads) else 0
        if budget >= 32:
            pre = order[:budget]
            routed[pre] = True
            pool.submit(pre)
        order = order[~(routed[order] | dov[order])]
        dov_sel = np.flatnonzero(dov & ~routed)
        if pool is not None:
            pool.submit(dov_sel)

    pending: list[dict] = []    # collected launches not yet assembled

    def ring_pass(rung: int, sub: np.ndarray, lanes_p: int,
                  cfg_p: EngineConfig, qchunk_p: int) -> list[int]:
        """Stream reads[sub] (hardest first) through the queued engine at
        lanes_p lanes, its inputs staged on the device once; returns the
        ids that overflowed their per-read ring budget."""
        failed: list[int] = []
        with sp("tier", rung=rung, lanes=lanes_p, reads=int(sub.size),
                streamed=0):
            staged = call.stage(sub, on_device=True)
            nframe = ring_statics(params, cfg_p, call.Lmax, 2,
                                  seed_slots=nseed).NFRAME
            Q = max(1, int(qchunk_p)) * lanes_p
            # a read's work bound must not bind before its ring budget
            need = (int(qchunk_p) + 2) * nframe + 4096
            cfg_r = dataclasses.replace(
                cfg_p, max_iters=max(int(cfg_p.max_iters), need))
            t0, wk0 = _tm.time_ns(), counters["work_units"]

            def collect(h: dict) -> None:
                host = call.collect(h)
                failed.extend(host["failed"].tolist())
                pending.append(host)

            # one-launch lookahead: dispatch k+1 before collecting k, so
            # per-launch host work overlaps the next launch's device time;
            # a launch's assembly waits for the next dispatch
            prev: dict | None = None
            for cs in range(0, sub.size, Q):
                h = call.dispatch(cfg_r, sub[cs:cs + Q], lanes_p, staged, cs)
                call.assemble(pending)
                if prev is not None:
                    collect(prev)
                prev = h
            if prev is not None:
                collect(prev)
            call.log_tier(lanes_p, cfg_p, sub.size, failed, t0,
                          work=counters["work_units"] - wk0)
        return failed

    # Escalation ladder, all rungs continuous-batching: the primary pass at
    # full lanes, then failures re-queue at one deep rung at the largest
    # per-read budget the same arena memory (cap * lanes) allows.  Reads
    # that out-run even that go to the host gold pool, which has been
    # chewing the pre-routed slice the whole time.
    failed: list[int] = []
    if order.size:
        failed = ring_pass(0, order, lanes, cfg, qchunk)
    if failed and RING_RUNG < lanes:
        counters["retried_reads"] += len(failed)
        sub = np.array(sorted(set(failed)), dtype=np.int64)
        if sort_reads:
            sub = sub[np.argsort(-z[sub], kind="stable")]
        failed = ring_pass(1, sub, RING_RUNG,
                           deep_tier_cfg(cfg, lanes, RING_RUNG, 0), 16)
    if pool is not None and failed:
        with sp("route"):
            pool.submit(sorted(set(failed)))
    call.assemble(pending)
    return [] if pool is not None else sorted(set(failed)) + dov_sel.tolist()


def _gold_finish(idx, reads: Reads, params: AlnParams, precalc,
                 pool: GoldPool | None, rest: list[int], results: list,
                 counters: dict, sp: Spans) -> None:
    """A call's gold step: wait for the pool, which took its reads as they
    surfaced, or, without one, gold-align `rest`; add them to
    `fallback_reads`, and the pool's stats.  The caller terminates it."""
    if pool is not None:
        counters["fallback_reads"] += pool.submitted
        with sp("gold.drain"):
            for orig, alns in pool.drain().items():
                results[orig] = alns
        counters.update(pool.stats())
    elif rest:
        counters["fallback_reads"] += len(rest)
        with sp("gold.drain"):
            for orig, alns in gold_fallback_many(
                    idx, reads, [int(i) for i in rest], params, precalc,
                    int(params.n_threads), counters).items():
                results[orig] = alns


def gold_fallback_many(idx, reads: Reads, sel: list[int], params: AlnParams,
                       precalc, n_threads: int,
                       stats: dict | None = None) -> dict[int, list]:
    """Gold-align reads[sel] (`precalc`: the `-P` seed table or None); with
    n_threads > 1 a GoldPool of that many workers (threads or spawned
    processes, by what they run) spreads the reads so overflow storms
    degrade gracefully.  `stats` gets the pool's kind, workers and start
    seconds when one ran."""
    if n_threads <= 1 or len(sel) <= 1:
        return {i: align_read_gold(idx, reads.seq[i], reads.rc[i],
                                   int(reads.lengths[i]), params,
                                   precalc=precalc) for i in sel}
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

