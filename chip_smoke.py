#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--genome-bp N] [--workdir DIR] [--only mesh_cards]

Drives the port's paths through the entry points a user calls, and holds
every hand-written kernel entry against its plain PyTorch version on the
card.  Each phase prints one JSON line as it finishes; any failed phase makes
the exit code non-zero.  Without a CUDA device the script fails at once: it
has no CPU mode.  The last line is
{"ok": true, "device": {"platform": "gpu", "kind": "<card>", "count": N}}.

Phases: device; build (native C++ library and CUDA kernels, from the sources
in this checkout); kernels (kernel == plain version, exact equality of every
output, path, flag and counter: the ring search and the fixed-batch search,
each in multi-genome and in single-genome mode, on the small test worlds);
main_path (`index` + `align -n 4 --queued` on the chr21-scale multi-genome
world: CLI, then the timed in-process run, `.aln` byte-compared with the
gold engine's); fixed_path (`align -n 4` as the quick start types it, no
`--queued`, on the same world and reads); more kernel comparisons on reads
of the main world at the settings of the main path's two launches and of
the fixed path's two tiers; mesh_path (`align -n 4 --mesh 1` through the
CLI on the same world and reads: the fixed tiers over a mesh of the one
card, `.aln` byte-equal to fixed_path's, and one launch of
sharded_inexact_search equal to inexact_search); tp_path (`--mesh 1,2`
and `--mesh 2,2` in-process on mesh rows that name this card two times:
the index range-sharded over tp, the sharded fixed kernel, `.aln`
byte-equal to fixed_path's, and one sharded launch at (1, 2) equal to the
unsharded one); mesh_cards (with two cards or more: the dependent-row
latency of a peer card's rows beside this card's, then `--mesh 1,N`,
`2,2`, `2` and `4` through the CLI across the cards, `.aln` byte-equal to
fixed_path's, each dp member's search time and whether the members'
launches overlapped, which at dp > 1 they must in every dispatch; on one
card a line saying that it did not run);
dist_path (two `--dist`
processes on the card, each with half of fixed_path's `-t`, the merged
`.aln` byte-equal to fixed_path's); easy_path (the easy 5 Mbp world, fixed batches
of 8 192); single_path (the same world as a plain 4-letter reference, `-S`);
kernel comparisons on the easy world at the lane counts, arenas and
alphabets these two paths launch; precalc (the k = 12 seed table of the
easy world built on the card, written as `.pre`, read back, and sampled
against the gold engine); pre_path (`align -n 4 -P` on the easy world,
fixed batches of 8 192: the seeded launches, the gold pool on spawned
processes, its kind, workers and start seconds); seeded comparisons on the
small worlds, on the easy world at pre_path's settings and on main-world
reads with a precalc_len-10 table built on the card; sam (`aln2sam` with
SA rows resolved on the card); probes (the three row-fetch probes through
their entry points at their own sizes, then each probe kernel against its
plain version, exact equality, beside the one PyTorch call that computes
the same function where there is one; `dma_wave` at the main path's 512
lanes gives the card's latency of a dependent row fetch); int64_path (the
main world's index in the int64 layout, aligned as fixed_path aligns it,
`.aln` byte-equal to fixed_path's; the int64 fixed kernel against its plain
version on main-world reads and on a virtual-offset index whose counts lie
past 2^33); then the rest of the plain versions and every comparison line;
then the `{"kernels": [...]}` line and the last line.  The small-world
comparisons also run the int64 layout's instantiations, and the sharded
fixed instantiations on tables range-sharded over tp = 2 and 3 copies on
this card (the small worlds in both alphabets and layouts, main-world
reads, the virtual-offset index).  Before each path
the launch counts are set to 0 and after it they are read: a path that did
not launch its kernel fails.

The plain versions (one lockstep iteration per pop of a comparison's
longest read, bound by the dispatch of small ops) run on host copies of the
comparisons' inputs, on the CPU, in spawned worker processes side by side,
after the last timed section, so no timed section shares the card or the
host with them.  Search launches are timed by the two CUDA events that the
kernel's C launch records right around each launch (`t_search`, and every
comparison: no host work of the wrapper between them); the probe kernels
K5 and K6 and their library calls by replays of a CUDA graph of many calls,
beside an empty kernel of the same grid (the launch floor, which bounds a
call whose bytes take less); K4 against a latency bound, K times the ns a
wave of its lightest comparison.
The build phase prints what `-Xptxas -v` says of each instantiation
(registers, stack, spills); main_path.profile is one try of torch.profiler
over the main path's call (the card's own busy share).

`--only mesh_cards` runs the device and build phases, the main world, its
index and fixed_path's CLI run, then mesh_cards alone: the call to make
on a machine of several cards.
"""

from __future__ import annotations

import argparse
import dataclasses
import filecmp
import gc
import json
import multiprocessing
import os
import socket
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ProcessPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
GENOME_BP = 46_700_000
NUM_READS = 16_384
BENCH_READS = 8_192
# published peaks of one H100 SXM: device memory rate, and the float32 rate
# outside the tensor cores taken as the rate of the kernel's integer work
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12
# pre_path reads held against the Python gold engine: 1 024 reads took 3.9 s
# on 8 spawned workers beside an H100, so four times as many fit easily
PRE_GOLD_READS = 4096
T0 = time.time()
GC_SECONDS = [0.0, 0.0]     # seconds in Python's collector so far; start


def _gc_clock(phase: str, _info) -> None:
    if phase == "start":
        GC_SECONDS[1] = time.time()
    else:
        GC_SECONDS[0] += time.time() - GC_SECONDS[1]


def host_mark() -> tuple:
    """The process's CPU seconds, its collector's seconds and the host's
    load average, now."""
    return time.process_time(), GC_SECONDS[0], os.getloadavg()[0]


def host_since(mark: tuple) -> dict:
    """Where a timed call's host time went since `mark`: the process's CPU
    seconds (all its threads), the seconds in Python's garbage collector,
    and the host's one-minute load average at the start."""
    return dict(cpu_seconds=time.process_time() - mark[0],
                gc_seconds=GC_SECONDS[0] - mark[1], loadavg_1min=mark[2])


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, "t": round(time.time() - T0, 1), **kw}),
          flush=True)


def fail(phase: str, why: str) -> None:
    emit(phase, ok=False, error=why)
    sys.exit(1)


def _gold_job(bwt: str, params, seq, rc, lengths, entries) -> list:
    """The Python gold engine on a chunk of reads, in a worker process:
    the index from `bwt`, and the seed lists of the table `entries` these
    reads look up, each from the gold engine's exact_match (an entry ->
    intervals mapping serves as the table), so that the reference does not
    read the table under test."""
    import numpy as np
    sys.path.insert(0, ROOT)
    from bwbble_tpu_torch.align.pipeline import align_read_gold
    from bwbble_tpu_torch.gold.engine import exact_match
    from bwbble_tpu_torch.index.fmindex import FMIndex
    idx = FMIndex.load(bwt, load_sa=False)
    k = int(params.precalc_len)
    rows = {e: exact_match(idx, np.array([(e >> (2 * (k - 1 - q))) & 3
                                          for q in range(k)], dtype=np.int8),
                           k, params) for e in entries}
    return [align_read_gold(idx, seq[i], rc[i], int(lengths[i]), params,
                            precalc=rows) for i in range(len(lengths))]


_PLAIN_INDEX: dict = {}


class LaunchEvents:
    """A search launch's timer: the kernel's wrapper sets `events` to the
    two CUDA events its C launch records right around the kernel."""
    events = None


def _plain_job(index_file: str, host_in: list, seeds, params, cfg,
               fixed: bool):
    """One comparison's plain version in a worker process, on the CPU, on
    host copies of its inputs (the index from `index_file`, kept for the
    worker's later jobs): (milliseconds, its per-read outputs as numpy)."""
    import torch
    sys.path.insert(0, ROOT)
    torch.set_num_threads(1)
    from bwbble_tpu_torch.engine.device_index import DeviceIndex
    from bwbble_tpu_torch.engine.inexact import (fixed_search_plain,
                                                 ring_search_plain)
    didx = _PLAIN_INDEX.get(index_file)
    if didx is None:
        fields = torch.load(index_file)
        if fields["tp_tables"] is not None:
            fields["tp_tables"] = tuple(fields["tp_tables"])
        didx = _PLAIN_INDEX[index_file] = DeviceIndex(**fields)
    a = [torch.from_numpy(x) for x in host_in]
    sd = None if seeds is None else tuple(torch.from_numpy(x) for x in seeds)
    t0 = time.time()
    if fixed:
        ref = fixed_search_plain(didx, *a, params, cfg, sd)
    else:
        # per-read results do not depend on the lane that serves a read,
        # so the plain version runs all reads as one lockstep chunk
        ref = ring_search_plain(didx, *a, params, cfg, a[0].shape[0], sd)
    ms = (time.time() - t0) * 1e3
    # which lane served a read is free; the arena is walked on the card
    return ms, {k: v.numpy() for k, v in ref.items()
                if k not in ("o_lane", "arena")}


def sync_all() -> None:
    """Wait for every card of the machine."""
    import torch
    for d in range(torch.cuda.device_count()):
        torch.cuda.synchronize(d)


def timed_cli(argv):
    """One CLI call: (exit code, seconds)."""
    from bwbble_tpu_torch import cli
    t0 = time.time()
    code = cli.main(argv)
    sync_all()
    return code, time.time() - t0


def cli_with_stats(argv):
    """One CLI call whose align_reads_device call also fills a stats dict:
    (exit code, CLI seconds, stats, seconds of that call)."""
    from bwbble_tpu_torch.engine import pipeline as pipeline_mod
    st: dict = {}
    inner = [0.0]
    align = pipeline_mod.align_reads_device

    def timed(*a, stats=None, **kw):
        t0 = time.time()
        out = align(*a, stats=st, **kw)
        sync_all()
        inner[0] = time.time() - t0
        if stats is not None:
            stats.update(st)
        return out
    pipeline_mod.align_reads_device = timed
    mark = host_mark()
    try:
        code, sec = timed_cli(argv)
    finally:
        pipeline_mod.align_reads_device = align
    st.update(host_since(mark))
    return code, sec, st, inner[0]


def mesh_cards(fa: str, fq: str, wdir: str, ref_aln: str, ref_seconds: float,
               threads: int, card: str) -> None:
    """First `peer_rows` (a peer card's row latency), then `align -n 4
    --mesh ...` through the CLI across the cards of this machine, at
    fixed_path's settings on its world and reads: `--mesh 1,N`
    (N = min(4, cards): the table range-sharded over N cards, rows read by
    peer access), `--mesh 2,2` (4 cards), `--mesh 2` and `--mesh 4` (dp >
    1).  Each `.aln` must be byte-equal to `ref_aln` (fixed_path's CLI
    `.aln`) and each run must launch its kernel.  A line a mesh: reads/s,
    each dp member's search seconds (the events its launches record), and
    whether the members' launches of a dispatch overlapped in time (their
    events against a reference event recorded on every card at the start,
    after a wait for every card); at dp > 1 they must in every dispatch.
    A mesh that raises (as one would whose
    cards cannot reach each other) is reported with its message; the phase
    fails after the last mesh if any failed.  On one card: one line saying
    that the phase did not run."""
    import torch
    from bwbble_tpu_torch.engine import kernel
    from bwbble_tpu_torch.engine import pipeline as pipeline_mod
    ncards = torch.cuda.device_count()
    if ncards < 2:
        emit("mesh_cards", ran=False, cards=ncards,
             why="one card: a mesh across cards needs dp * tp of them "
                 "(tp_path shards the table over this card instead)",
             card=card)
        return
    failed = []
    try:
        peer_rows(card)
    except RuntimeError as ex:                   # reported, then failed
        emit("mesh_cards.peer_rows", ok=False, error=repr(ex)[:2000],
             card=card)
        failed.append("peer_rows")
    specs = [f"1,{min(4, ncards)}", "2"]
    if ncards >= 4:
        specs += ["2,2", "4"]
    base = pipeline_mod._LaunchTimer
    for spec in specs:
        dims = [int(x) for x in spec.split(",")]
        dp, tp = dims[0], dims[1] if len(dims) > 1 else 1
        out = os.path.join(wdir, f"mesh_cards_{dp}x{tp}.aln")
        if os.path.exists(out):
            os.remove(out)
        timers: list = []

        class Recorded(base):
            def __init__(self, dev_):
                super().__init__(dev_)
                timers.append(self)
        sync_all()
        refs = []
        for d in range(ncards):
            with torch.cuda.device(d):
                refs.append(torch.cuda.Event(enable_timing=True))
                refs[-1].record()
        for k in kernel.LAUNCHES:
            kernel.LAUNCHES[k] = 0
        pipeline_mod._LaunchTimer = Recorded
        try:
            rc, sec, st, dt = cli_with_stats(
                ["align", "-n", "4", "-t", str(threads), "--mesh", spec, fa,
                 fq, out])
            error = None
        except Exception as ex:                  # reported, then failed
            rc, sec, st, dt, error = None, None, {}, None, repr(ex)[:2000]
        finally:
            pipeline_mod._LaunchTimer = base
        key = "fixed_search_tp" if tp > 1 else "fixed_search"
        launches = dict(kernel.LAUNCHES)
        same = rc == 0 and filecmp.cmp(out, ref_aln, shallow=False)
        # a dispatch makes one timer a dp member, in member order; member
        # m launches on its row's first card, cuda:(m * tp) (make_mesh over
        # every card in order, as the CLI makes it)
        member_s = [0.0] * dp
        groups = [] if error else [timers[i:i + dp]
                                   for i in range(0, len(timers), dp)]
        overlapped = 0
        for g in groups:
            spans = []
            for m, tm_ in enumerate(g):
                ev0, ev1 = tm_.events
                ev1.synchronize()
                ref = refs[m * tp]
                spans.append((ref.elapsed_time(ev0), ref.elapsed_time(ev1)))
                member_s[m] += (spans[-1][1] - spans[-1][0]) / 1e3
            overlapped += len(g) > 1 and max(a for a, _ in spans) < min(
                b for _, b in spans)
        # dp > 1: every dispatch's member launches must overlap in time,
        # as the dp members of the JAX package's shard_map run at once
        ok = bool(same and launches[key] > 0 and error is None
                  and sum(launches.values()) == launches[key]
                  and (dp == 1 or (groups and overlapped == len(groups))))
        emit("mesh_cards", ok=ok, mesh=spec, dp=dp, tp=tp, cards=dp * tp,
             same_as_fixed_path=same, error=error, returncode=rc,
             reads_per_sec=None if dt is None else BENCH_READS / dt,
             seconds=dt, cli_seconds=sec, fixed_cli_seconds=ref_seconds,
             t_dbounds=st.get("t_dbounds"), t_search=st.get("t_search"),
             t_host=st.get("t_host"), fallback_reads=st.get("fallback_reads"),
             member_t_search=member_s, dispatches=len(groups),
             overlapped_dispatches=overlapped if dp > 1 else None,
             launches={k: v for k, v in launches.items() if v},
             cpu_seconds=st.get("cpu_seconds"), card=card)
        if not ok:
            failed.append(spec)
    if failed:
        fail("mesh_cards", f"{failed}: peer rows refused or read wrong, or "
                           "a mesh's `.aln` differs from fixed_path's, its "
                           "run raised, it did not launch its kernel "
                           "(alone), or its dp members' launches did not "
                           "overlap in every dispatch")


def peer_rows(card: str) -> None:
    """The dependent-row latency of a peer card's rows beside this card's:
    K4's wave kernel (512 lanes, 256 dependent waves of 512-byte rows of
    the probe's 913 021-row table), launched on cuda:0 over the table on
    cuda:0 and over a copy on cuda:1 read by peer access, in turns, three
    rounds of five launches timed by events (its C launch called directly:
    the wrapper takes one card's tensors; nothing is counted).  The two
    outputs must be equal.  Raises RuntimeError where cuda:0 cannot reach
    cuda:1."""
    import torch
    from bwbble_tpu_torch.benchmarks import dma_probe
    from bwbble_tpu_torch.benchmarks import kernels as probe_k
    from bwbble_tpu_torch.engine import kernel
    c0, c1 = torch.device("cuda", 0), torch.device("cuda", 1)
    kernel.enable_peer(c0, c1)
    lib = probe_k._load()
    lanes, waves, reps = 512, 256, 5
    tbl, idxs = dma_probe.make_inputs(lanes, dma_probe.N, c0, seed=1, sets=1)
    tables = {"local": tbl, "peer": tbl.to(c1)}
    outs = {k: torch.empty_like(idxs[0]) for k in tables}
    ns: dict = {k: [] for k in tables}
    st = torch.cuda.current_stream(c0)
    with torch.cuda.device(c0):
        for _round in range(3):
            for k, tb in tables.items():
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record(st)
                for _ in range(reps):
                    rc = lib.dma_wave_launch(
                        idxs[0].data_ptr(), tb.data_ptr(), outs[k].data_ptr(),
                        lanes, waves, dma_probe.N, 0, st.cuda_stream)
                    if rc != 0:
                        raise RuntimeError(f"dma_wave over the {k} table: "
                                           f"CUDA error {rc}")
                ev[1].record(st)
                ev[1].synchronize()
                ns[k].append(ev[0].elapsed_time(ev[1]) * 1e6 / reps / waves)
    med = {k: sorted(v)[1] for k, v in ns.items()}
    equal = torch.equal(outs["local"], outs["peer"])
    emit("mesh_cards.peer_rows", ok=equal, lanes=lanes, waves=waves,
         row_bytes=512, ns_a_wave_local=med["local"],
         ns_a_wave_peer=med["peer"],
         peer_over_local=med["peer"] / med["local"], rounds=ns,
         outputs_equal=equal, card=card)
    if not equal:
        raise RuntimeError("dma_wave over the peer table differs from the "
                           "local one")


def ptxas_report(lines: list[str]) -> list[dict]:
    """Registers, stack and spills of each ring_search_kernel instantiation
    from nvcc's `-Xptxas -v` report (`, tp`: on a sharded table)."""
    import re
    names = {"1": "multiref", "0": "single"}
    out, cur = [], None
    for ln in lines:
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            k = re.search(r"ring_search_kernelILb([01])ELb([01])E([ix])"
                          r"Lb([01])E", m.group(1))
            cur = None if k is None else {
                "instantiation": f"<{names[k.group(1)]}, "
                f"{'fixed' if k.group(2) == '1' else 'ring'}, "
                f"{'i64' if k.group(3) == 'x' else 'i32'}"
                f"{', tp' if k.group(4) == '1' else ''}>"}
            if cur is not None:
                out.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m:
            cur.update(stack_bytes=int(m.group(1)),
                       spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            cur["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", ln)
            cur["static_smem_bytes"] = int(m.group(1)) if m else 0
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--genome-bp", type=int, default=GENOME_BP)
    ap.add_argument("--workdir", default=os.path.join(ROOT, ".bench_torch"))
    ap.add_argument("--only", choices=("mesh_cards",), default=None)
    args = ap.parse_args()
    threads = max(1, min(8, os.cpu_count() or 1))   # host gold / D scan
    if args.genome_bp < 8_000_000:
        print("--genome-bp may not go below 8 Mbp", file=sys.stderr)
        return 2

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device: this script runs on the GPU only",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from bwbble_tpu_torch import build_native, cli, worlds
    from bwbble_tpu_torch.align.params import AlnParams
    from bwbble_tpu_torch.engine import kernel
    from bwbble_tpu_torch.benchmarks import (dma_probe, gather_bench,
                                             gather_pallas_probe)
    from bwbble_tpu_torch.benchmarks import kernels as probe_k
    from bwbble_tpu_torch.engine.device_index import (build_planes,
                                                      from_arrays,
                                                      from_fmindex)
    from bwbble_tpu_torch.engine.rank import rank_all_exact
    from bwbble_tpu_torch.formats.fastq import parse_fastq_bytes
    from bwbble_tpu_torch.align.pipeline import (align_reads_gold,
                                                 alns_to_sam)
    from bwbble_tpu_torch.align.precalc import (build_precalc_device,
                                                build_precalc_gold, load_pre,
                                                read_indices, store_pre)
    from bwbble_tpu_torch.engine import pipeline as pipeline_mod
    from bwbble_tpu_torch.engine.inexact import (EngineConfig,
                                                 inexact_search,
                                                 ring_statics, unpack_paths,
                                                 walk_paths)
    from bwbble_tpu_torch.engine.pipeline import (LADDER, _calc_d_chunk,
                                                  align_reads_device,
                                                  deep_tier_cfg,
                                                  gold_fallback_many,
                                                  native_scan_chunks)
    from bwbble_tpu_torch.formats.aln import read_aln_file, write_aln_file
    from bwbble_tpu_torch.formats.fasta import read_ann
    from bwbble_tpu_torch.formats.fastq import read_fastq
    from bwbble_tpu_torch.gold.engine import calculate_d, exact_match
    from bwbble_tpu_torch.index.fmindex import FMIndex
    from bwbble_tpu_torch.native import get_native
    from bwbble_tpu_torch.parallel import (make_mesh, sharded_align_step,
                                           sharded_inexact_search)

    dev = torch.device("cuda")
    dev0 = torch.device("cuda", 0)
    gc.callbacks.append(_gc_clock)

    # ---------------------------------------------------------------- device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        and smi.stdout.strip() else "nvidia-smi unavailable"
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    emit("device", card=card, torch=torch.__version__,
         cuda=torch.version.cuda, kind=torch.cuda.get_device_name(0),
         sms=sms)

    # ----------------------------------------------------------------- build
    t = time.time()
    # one nvcc for each CUDA source, all started together, beside g++
    nvcc = {name: subprocess.Popen(
        [sys.executable, "-c", "from bwbble_tpu_torch.engine import kernel; "
         f"print(kernel.build({name!r}))"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name in ("ring_search", "probes")}
    try:
        build_native.build(verbose=False)       # g++, alongside nvcc
    finally:
        built = {name: p.communicate() for name, p in nvcc.items()}
    for name, p in nvcc.items():
        if p.returncode != 0:
            fail("build", f"{name} build failed: " + built[name][1][-2000:])
    nat = get_native()
    if nat is None or not nat._has_gold or not nat._has_calc_d:
        fail("build", "native library did not load")
    kernel._load()
    probe_k._load()
    ptxas, libs = {}, {}
    for name, (k_out, _err) in built.items():
        libs[name] = os.path.relpath(k_out.strip(), ROOT)
        with open(k_out.strip() + ".log") as f:
            # one entry per instantiation of each template
            ptxas[name] = [ln.strip().replace("ptxas info    : ", "")
                           for ln in f if "Compiling entry" in ln
                           or "registers" in ln or "stack frame" in ln]
    regs = ptxas_report(ptxas["ring_search"])
    emit("build", ok=True, seconds=round(time.time() - t, 1),
         kernel_libs=libs, ptxas=ptxas)
    for r in regs:
        emit("build.ptxas", kernel="ring_search_kernel", **r)
    if len(regs) != 10:
        fail("build", f"ring_search: not ten instantiations in the ptxas "
                      f"report: {regs}")

    def last_line() -> None:
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)

    if args.only == "mesh_cards":
        # the main world, its index and fixed_path's CLI run (the `.aln`
        # each mesh is held against), then mesh_cards alone
        wdir = os.path.join(args.workdir, f"chr21_{args.genome_bp}")
        fa, fq_all = worlds.chr21_world(
            wdir, genome_bp=args.genome_bp, num_reads=NUM_READS,
            log=lambda m: emit("main_path.world", step=m))
        fq = worlds.subset_fastq(fq_all, BENCH_READS)
        if cli.main(["index", fa]) != 0:
            fail("main_path", "index failed")
        ref_aln = os.path.join(wdir, "fixed_cli.aln")
        for k in kernel.LAUNCHES:
            kernel.LAUNCHES[k] = 0
        rc, t_cli = timed_cli(["align", "-n", "4", "-t", str(threads), fa, fq,
                               ref_aln])
        if rc != 0 or kernel.LAUNCHES["fixed_search"] == 0:
            fail("fixed_path", f"CLI align rc={rc} launches={kernel.LAUNCHES}")
        emit("fixed_path", ok=True, cli_only=True, cli_seconds=t_cli,
             cli_launches=kernel.LAUNCHES["fixed_search"], card=card)
        mesh_cards(fa, fq, wdir, ref_aln, t_cli, threads, card)
        print(card, flush=True)
        last_line()
        return 0

    # --------------------------------------------------------------- kernels
    def exact_d(idx, rd, params):
        """Exact D bounds from the gold engine (small worlds)."""
        Lmax, sl = rd.max_len, int(params.seed_length)
        D = np.zeros((rd.count, Lmax + 1, 2), dtype=np.int32)
        Ds = np.zeros((rd.count, sl + 1, 2), dtype=np.int32)
        for r in range(rd.count):
            ln = int(rd.lengths[r])
            D[r, :ln + 1] = calculate_d(idx, rd.seq[r], ln, params)
            if ln > sl:
                Ds[r] = calculate_d(idx, rd.seq[r], sl, params)
        return D, Ds

    cmps: list[dict] = []       # every comparison, for the `kernels` line
    PLAIN_PIECE = 128           # reads a piece of a plain version's run
    os.makedirs(args.workdir, exist_ok=True)
    plain_index: dict = {}      # id(index) -> (its host copy's file, index)

    def index_file(didx) -> str:
        """A host copy of `didx`, written once, for the plain versions'
        workers."""
        if id(didx) not in plain_index:
            path = os.path.join(args.workdir,
                                f"plain_index_{len(plain_index)}.pt")
            torch.save(dict(table=didx.table.cpu(), Carr=didx.Carr.cpu(),
                            sa_samples=didx.sa_samples.cpu(),
                            length=int(didx.length), sa0=int(didx.sa0),
                            tp_tables=None if didx.tp_tables is None else
                            [t.cpu() for t in didx.tp_tables]), path)
            plain_index[id(didx)] = (path, didx)
        return plain_index[id(didx)][0]

    def device_d(didx, rd, params, K):
        """D bounds of all of `rd` from one device pass at list width K."""
        ln = rd.lengths.astype(np.int32)
        D, Ds, dov = _calc_d_chunk(didx, np.asarray(rd.seq, dtype=np.int8),
                                   ln, ln, params, K)
        if bool(dov.any()):
            fail("kernels", f"device D pass overflowed its lists at K={K}")
        return D.cpu().numpy(), Ds.cpu().numpy()

    def compare(name, didx, rc, lengths, D, Ds, params, cfg, lanes,
                seeds=None, seed_over=None):
        """One kernel entry on the card (`lanes` None: the fixed-batch
        search, else the ring search at that many lanes; `seeds`: None, or
        (seed_L, seed_U, seed_cnt) numpy arrays of a seeded search), timed
        after a warm-up; its plain version runs in `resolve_plain`, on host
        copies of the inputs, after the last timed section.  Every per-read output, path, overflow flag,
        reason and counter must then be equal (integers: tolerance zero),
        and for a fixed batch `walk_paths` over the returned arena must give
        the in-kernel walk.  Returns the comparison's record; `over` (the
        kernel's per-read overflow flags) is there at once, the plain
        version's numbers once resolved."""
        host_in = [np.ascontiguousarray(x) for x in
                   (np.asarray(rc, dtype=np.int8), lengths.astype(np.int32),
                    D, Ds)]
        a = [torch.from_numpy(x).to(dev) for x in host_in]
        sd_host = None if seeds is None else [
            np.ascontiguousarray(x, dtype=dt) for x, dt in zip(
                seeds, (np.int64 if didx.idt == torch.int64 else np.int32,) * 2
                + (np.int32,))]
        sd = None if seeds is None else tuple(
            torch.from_numpy(x).to(dev) for x in sd_host)
        n = a[0].shape[0]
        x64 = didx.idt == torch.int64
        tp = 1 if didx.tp_tables is None else len(didx.tp_tables)
        entry = ("fixed_search" if lanes is None else "ring_search") + (
            "" if seeds is None else "_seeded") + ("_tp" if tp > 1 else "") \
            + ("_i64" if x64 else "")
        if lanes is None:
            def run(tm):
                return kernel.fixed_search(didx, *a, params, cfg, sd, tm)
        else:
            def run(tm):
                return kernel.ring_search(didx, *a, params, cfg, lanes, sd,
                                          tm)
        run(None)                                             # warm-up
        torch.cuda.synchronize()
        tm = LaunchEvents()
        got = run(tm)
        torch.cuda.synchronize()
        ms = tm.events[0].elapsed_time(tm.events[1])
        walked = None
        S = ring_statics(params, cfg, a[0].shape[1], a[3].shape[1],
                         fixed=lanes is None,
                         seed_slots=0 if seeds is None else sd[0].shape[1],
                         x64=x64)
        if lanes is None:
            live = (torch.arange(S.ACAP, device=dev)[None, :]
                    < got["n_alns"][:, None])
            ln_i, sl_i = live.nonzero(as_tuple=True)
            w = walk_paths(got["arena"], ln_i, got["o_node"][ln_i, sl_i],
                           nroot=S.NROOT, nslot=S.NSLOT, nc=S.NC,
                           pathcap=S.PATHCAP, nw=S.NW).cpu().numpy()
            inker = unpack_paths(got["paths"].cpu().numpy(), S.PATHCAP)
            walked = bool((w == inker[ln_i.cpu().numpy(),
                                      sl_i.cpu().numpy()]).all())
        tot = {k: int(got[k].sum(dtype=torch.int64)) for k in
               ("n_work", "pops", "rank_rows", "frame_rd", "frame_wr",
                "root_rd", "n_alns", "overflow")}
        io_bytes = sum(x.nbytes for x in host_in) + sum(
            got[k].numel() * got[k].element_size()
            for k in ("o_L", "o_U", "o_score", "o_len", "o_node", "o_snp",
                      "o_plen", "paths", "n_alns", "overflow"))
        roots = {}
        if seeds is not None:
            # the kernel reads a read's seed count, and of its seed rows
            # only those it pops: `root_rd` in bound_ms charges those
            io_bytes += sd_host[2].nbytes
            sc = np.minimum(sd_host[2], S.NROOT)
            roots = dict(seed_slots=S.NROOT, precalc_len=S.PK,
                         roots_mean=float(sc.mean()), roots_max=int(sc.max()),
                         multi_root_share=float((sc > 1).mean()),
                         no_seed_hit_share=float((sc == 0).mean()),
                         seed_over_share=float(np.mean(seed_over)))
        # work units (pops and exact-completion characters) of the busiest
        # lane: a chain of dependent fetches, the base of a latency bound
        lane = got["o_lane"].cpu().numpy()
        lane_work_max = int(np.bincount(
            lane, weights=got["n_work"].cpu().numpy()).max())
        rec = dict(ms=ms, io_bytes=io_bytes, reads=n, x64=x64,
                   lane_work_max=lane_work_max, **tot)
        b_ms, b_by = bound_ms(rec)
        smem = kernel.block_smem_bytes(S)
        # the lanes an SM holds at once, and the waves of them the launch
        # needs on this card
        per_sm = kernel.resident_lanes(S, sharded=tp > 1)
        used = n if lanes is None else min(lanes, n)
        line = dict(
            world=name, entry=entry, tp=tp,
            alphabet=16 if params.is_multiref else 4, reads=n,
            lanes_used=used,
            refills=0 if lanes is None else max(0, n - lanes),
            cap=cfg.cap, acap=cfg.acap, xc=cfg.xcap or cfg.kx,
            finished_share=1.0 - tot["overflow"] / n, kernel_ms=ms,
            bound_ms=b_ms, bound_by=b_by, lane_work_max=lane_work_max,
            smem_block_bytes=smem, resident_lanes_per_sm=per_sm,
            waves=-(-used // (per_sm * sms)),
            walk_paths_equal=walked, **roots)
        rec.update(line=line, totals=tot, walked=walked,
                   shape=(entry, S.NB, S.Lmax, S.DS, S.XC, smem),
                   plain_job=(index_file(didx), host_in, sd_host, params,
                              cfg, lanes is None),
                   got={k: v.cpu().numpy() for k, v in got.items()
                        if k != "arena"},
                   over=got["overflow"].cpu().numpy())
        cmps.append(rec)
        if walked is False:
            fail("kernels", f"walk_paths over the arena != the in-kernel "
                            f"walk: {entry} on {name}")
        return rec

    def plain_pieces(i: int) -> list:
        """Comparison i's plain job cut into read ranges of at most
        PLAIN_PIECE reads (at most eight): (cost, i, first read, job).  A
        read's plain result does not depend on the reads beside it, so the
        pieces' outputs, joined in order, are the whole comparison's; the
        cost (the longest read's work units, one lockstep iteration each,
        times the lanes) orders them, the costliest first."""
        c = cmps[i]
        f_idx, host_in, sd, params_, cfg_, fixed = c.pop("plain_job")
        n = host_in[0].shape[0]
        k = min(8, -(-n // PLAIN_PIECE))
        step = -(-n // k)
        work = c["got"]["n_work"]
        out = []
        for s0 in range(0, n, step):
            s1 = min(n, s0 + step)
            job = (f_idx, [x[s0:s1] for x in host_in],
                   None if sd is None else [x[s0:s1] for x in sd],
                   params_, cfg_, fixed)
            out.append((int(work[s0:s1].max()) * (1 + (s1 - s0) / 512), i,
                        s0, job))
        return out

    def resolve_plain() -> None:
        """Run every comparison's plain version on host copies of its
        inputs, cut into pieces, in `threads` spawned worker processes side
        by side (the costliest pieces first), and hold each kernel result
        against it."""
        t = time.time()
        pieces = sorted((p for i in range(len(cmps))
                         for p in plain_pieces(i)), key=lambda p: -p[0])
        wrong, piece_max = [], 0.0
        with ProcessPoolExecutor(
                threads,
                mp_context=multiprocessing.get_context("spawn")) as ex:
            futs: dict = {}
            for _cost, i, s0, job in pieces:
                futs.setdefault(i, []).append(
                    (s0, ex.submit(_plain_job, *job)))
            for i, c in enumerate(cmps):
                parts = [(s0, f.result()) for s0, f in sorted(
                    futs.pop(i), key=lambda x: x[0])]
                plain_ms = sum(r[0] for _s0, r in parts)
                piece_max = max([piece_max] + [r[0] for _s0, r in parts])
                ref = {k: np.concatenate([r[1][k] for _s0, r in parts])
                       for k in parts[0][1][1]}
                n_pieces = len(parts)
                del parts
                bad, err = [], 0
                for k, v in ref.items():
                    d = np.abs(v.astype(np.int64)
                               - c["got"][k].astype(np.int64))
                    if d.size and int(d.max()) != 0:
                        bad.append(k)
                        err = max(err, int(d.max()))
                del ref
                lat = latency_ms(c["lane_work_max"])
                c.update(plain_ms=plain_ms, err=err, equal=not bad)
                c["line"].update(equal_to_plain=not bad, plain_ms=plain_ms,
                                 plain_pieces=n_pieces,
                                 latency_bound_ms=lat,
                                 time_over_latency_bound=c["ms"] / lat
                                 if lat else None)
                emit("kernels.compare", mismatched=bad, **c["line"],
                     **c["totals"])
                if bad:
                    wrong.append(f"{c['line']['entry']} on "
                                 f"{c['line']['world']}: {bad}")
        emit("kernels.plain", comparisons=len(cmps), pieces=len(pieces),
             workers=threads,
             seconds=round(time.time() - t, 1),
             plain_ms_sum=sum(c["plain_ms"] for c in cmps),
             plain_ms_max=max(c["plain_ms"] for c in cmps),
             piece_ms_max=piece_max)
        if wrong:
            fail("kernels", "kernel != plain version: " + "; ".join(wrong))

    def bound_ms(c):
        """Least time the card could take for the work these inputs need:
        the bytes moved (per-read inputs and outputs once, plus what the
        kernel's own counters say the search had to touch: 128-byte rank
        rows, 16-byte popped slots, at least one 16-byte slot and the
        parent word per written frame, a root pop's seed interval: two
        words of seed_L and seed_U; on the int64 layout 192-byte rows,
        24-byte slots and 8-byte words) over the memory rate, against the
        integer operations (about 16 per symbol word of a rank row's 11-16
        symbols, ~1000 a row; ~300 a pop) over the ALU rate."""
        w = 2 if c.get("x64") else 1
        nbytes = (c["io_bytes"] + (128 + 64 * (w - 1)) * c["rank_rows"]
                  + (16 + 8 * (w - 1)) * (c["frame_rd"] + c["frame_wr"])
                  + 4 * c["frame_wr"] + 8 * w * c.get("root_rd", 0))
        ops = 1000 * c["rank_rows"] + 300 * c["pops"]
        tb, to = nbytes / PEAK_BYTES_S * 1e3, ops / PEAK_OPS_S * 1e3
        return max(tb, to), ("bytes" if tb >= to else "operations")

    def gold_table(idx, k):
        """The gold engine's seed table (small worlds only)."""
        return build_precalc_gold(idx, AlnParams(), k=k)

    def seeds_of(table, rd, k, slots):
        """The seeds `rd`'s reads look up in `table`: ((seed_L, seed_U,
        seed_cnt) int32, seed_over)."""
        ri = read_indices(np.asarray(rd.rc, dtype=np.int8),
                          rd.lengths.astype(np.int32), k=k)
        sL, sU, scnt, over = table.lookup_batch(ri, slots)
        return (sL.astype(np.int32), sU.astype(np.int32),
                scnt.astype(np.int32)), over

    def seeded_pair(name, didx, rd, D, Ds, params, cfg, table, slots,
                    lanes, cfg_fixed=None):
        """Seeded comparisons of both entries: the fixed batch (at
        `cfg_fixed`, else `cfg`) and the ring at `lanes` lanes."""
        sd, over = seeds_of(table, rd, int(params.precalc_len), slots)
        rc_, ln_ = np.asarray(rd.rc, dtype=np.int8), rd.lengths
        cf_ = compare(name, didx, rc_, ln_, D, Ds, params,
                      cfg_fixed or cfg, None, sd, over)
        cr_ = compare(name, didx, rc_, ln_, D, Ds, params, cfg, lanes, sd,
                      over)
        return cf_, cr_

    def sharded(didx_, tp):
        """`didx_` range-sharded over a mesh row that names this card `tp`
        times, as Mesh.place shards it (the last shard zero-padded)."""
        return make_mesh(1, tp, [dev0] * tp).place(didx_)[0]

    p3 = AlnParams(max_diff=3, batch_size=128)
    idx_s, rd_s = worlds.mixed_world()
    D, Ds = exact_d(idx_s, rd_s, p3)
    didx_s = from_fmindex(idx_s, device=dev)
    cfg_s = EngineConfig(cap=4096, acap=24, kx=2, max_iters=20_000, xcap=128)
    compare("mixed", didx_s, rd_s.rc, rd_s.lengths, D, Ds, p3, cfg_s, 64)
    compare("mixed", didx_s, rd_s.rc, rd_s.lengths, D, Ds, p3, cfg_s, None)
    # the sharded fixed instantiations: 63 blocks over tp = 2 (the last
    # shard padded with a zero row) and tp = 3, unseeded and seeded
    for tp in (2, 3):
        compare("mixed", sharded(didx_s, tp), rd_s.rc, rd_s.lengths, D, Ds,
                p3, cfg_s, None)
    sd, over = seeds_of(gold_table(idx_s, 4), rd_s, 4, 8)
    compare("mixed", sharded(didx_s, 2), rd_s.rc, rd_s.lengths, D, Ds,
            dataclasses.replace(p3, precalc_len=4, use_precalc=True), cfg_s,
            None, sd, over)
    # (a) seeded roots: a gold-built table at precalc_len 4 and 8 seed slots
    # (a 4-mer has dozens of intervals here: every read starts from 8 roots)
    p3s = dataclasses.replace(p3, precalc_len=4, use_precalc=True)
    seeded_pair("mixed", didx_s, rd_s, D, Ds, p3s, cfg_s,
                gold_table(idx_s, 4), 8, 16)
    # scores that need 340 buckets (the domain goes to 1024), 16 lanes for
    # the 48 reads so that lanes refill
    pw = AlnParams(max_diff=3, batch_size=128, mm_score=30, gapo_score=40,
                   gape_score=20)
    D, Ds = exact_d(idx_s, rd_s, pw)
    compare("mixed_wide_scores", didx_s, rd_s.rc, rd_s.lengths, D, Ds, pw,
            cfg_s, 16)
    with tempfile.TemporaryDirectory() as td:
        idx_s, rd_s = worlds.iupac_dense_world(td)
    D, Ds = exact_d(idx_s, rd_s, p3)
    didx_s = from_fmindex(idx_s, device=dev)
    cfg_d = EngineConfig(cap=8192, acap=24, kx=2, max_iters=60_000, xcap=128)
    compare("iupac_dense", didx_s, rd_s.rc, rd_s.lengths, D, Ds, p3, cfg_d, 32)
    compare("iupac_dense", didx_s, rd_s.rc, rd_s.lengths, D, Ds, p3, cfg_d,
            None)
    seeded_pair("iupac_dense", didx_s, rd_s, D, Ds, p3s, cfg_d,
                gold_table(idx_s, 4), 8, 16)
    # the 4-letter instantiations: ring (16 lanes for 48 reads, so lanes
    # refill) and fixed, D bounds from the device pass
    ps = AlnParams(max_diff=3, batch_size=128, is_multiref=False)
    idx_s, rd_s = worlds.single_genome_world()
    didx_s = from_fmindex(idx_s, device=dev)
    ln_s = rd_s.lengths.astype(np.int32)
    D, Ds = device_d(didx_s, rd_s, ps, 16)
    cfg_4 = EngineConfig(cap=4096, acap=24, kx=4, max_iters=20_000)
    c4r = compare("single_genome", didx_s, rd_s.rc, ln_s, D, Ds, ps, cfg_4, 16)
    c4f = compare("single_genome", didx_s, rd_s.rc, ln_s, D, Ds, ps, cfg_4,
                  None)
    if c4r["n_alns"] == 0 or c4r["n_alns"] != c4f["n_alns"]:
        fail("kernels", "the 4-letter searches reported no or unequal "
                        "alignments")
    for tp in (2, 3):
        compare("single_genome", sharded(didx_s, tp), rd_s.rc, ln_s, D, Ds,
                ps, cfg_4, None)
    # (b) the 4-letter instantiations, seeded (one root a read on a single
    # genome)
    seeded_pair("single_genome", didx_s, rd_s, D, Ds,
                dataclasses.replace(ps, precalc_len=4, use_precalc=True),
                cfg_4, gold_table(idx_s, 4), 8, 16)
    # the int64 layout's two instantiations (fixed batches only, as in the
    # JAX package): the single-genome world, then the mixed world unseeded
    # and seeded, each built in the int64 layout
    didx_s64 = from_fmindex(idx_s, use_int64=True, device=dev)
    D, Ds = device_d(didx_s64, rd_s, ps, 16)
    compare("single_genome_i64", didx_s64, rd_s.rc, ln_s, D, Ds, ps, cfg_4,
            None)
    compare("single_genome_i64", sharded(didx_s64, 2), rd_s.rc, ln_s, D, Ds,
            ps, cfg_4, None)
    idx_s, rd_s = worlds.mixed_world()
    didx_s64 = from_fmindex(idx_s, use_int64=True, device=dev)
    D, Ds = (x.astype(np.int64) for x in exact_d(idx_s, rd_s, p3))
    compare("mixed_i64", didx_s64, rd_s.rc, rd_s.lengths, D, Ds, p3, cfg_s,
            None)
    compare("mixed_i64", sharded(didx_s64, 3), rd_s.rc, rd_s.lengths, D, Ds,
            p3, cfg_s, None)
    sd, over = seeds_of(gold_table(idx_s, 4), rd_s, 4, 8)
    compare("mixed_i64", didx_s64, rd_s.rc, rd_s.lengths, D, Ds, p3s, cfg_s,
            None, sd, over)
    del didx_s64

    # ------------------------------------------------------------- main path
    reduced = {} if args.genome_bp == GENOME_BP else \
        {"genome_bp": args.genome_bp}
    wdir = os.path.join(args.workdir, f"chr21_{args.genome_bp}")
    t = time.time()
    fa, fq_all = worlds.chr21_world(
        wdir, genome_bp=args.genome_bp, num_reads=NUM_READS,
        log=lambda m: emit("main_path.world", step=m))
    fq = worlds.subset_fastq(fq_all, BENCH_READS)
    t_world = time.time() - t

    t = time.time()
    if cli.main(["index", fa]) != 0:
        fail("main_path", "index failed")
    t_index = time.time() - t
    emit("main_path.index", seconds=round(t_index, 1),
         world_seconds=round(t_world, 1))

    # first run, through the CLI: also the timed run's warm-up
    cli_aln = os.path.join(wdir, "cli.aln")
    kernel.LAUNCHES["ring_search"] = 0
    rc, t_cli = timed_cli(["align", "-n", "4", "-t", str(threads),
                           "--queued", "--batch", "512", "--arena", "655360",
                           fa, fq, cli_aln])
    cli_launches = kernel.LAUNCHES["ring_search"]
    if rc != 0 or cli_launches == 0:
        fail("main_path", f"CLI align rc={rc} launches={cli_launches}")
    emit("main_path.cli", seconds=round(t_cli, 1), launches=cli_launches)

    # timed run, in-process with the benchmark's configuration
    idx = FMIndex.load(fa + ".bwt", load_sa=False)
    reads = read_fastq(fq)
    didx = from_fmindex(idx, device=dev)
    params = AlnParams(max_diff=4, batch_size=512, n_threads=threads)
    cfg = EngineConfig(cap=655360, acap=24, kx=2, max_iters=500_000)
    stats: dict = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernel.LAUNCHES["ring_search"] = 0
    mark = host_mark()
    t = time.time()
    alns = align_reads_device(idx, didx, reads, params, cfg, d_cap=64,
                              queued=True, qchunk=16, stats=stats,
                              device=dev)
    torch.cuda.synchronize()
    dt = time.time() - t
    host = host_since(mark)
    main_launches = kernel.LAUNCHES["ring_search"]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    dev_aln = os.path.join(wdir, "device.aln")
    write_aln_file(dev_aln, alns)
    same_as_cli = filecmp.cmp(dev_aln, cli_aln, shallow=False)

    # parity: the whole file against the gold engine (native, threaded)
    t = time.time()
    gold = gold_fallback_many(idx, reads, list(range(reads.count)), params,
                              None, threads)
    gold_aln = os.path.join(wdir, "gold.aln")
    write_aln_file(gold_aln, [gold[i] for i in range(reads.count)])
    t_gold = time.time() - t
    parity = filecmp.cmp(dev_aln, gold_aln, shallow=False)
    n_aligned = sum(1 for a in alns if a)
    main = dict(
        reads=reads.count, aligned=n_aligned, index_len=int(idx.length),
        seconds=dt, reads_per_sec=reads.count / dt,
        t_dbounds=stats.get("t_dbounds"), t_search=stats.get("t_search"),
        t_host=stats.get("t_host"),
        fallback_reads=stats.get("fallback_reads"),
        retried_reads=stats.get("retried_reads"),
        prerouted=stats.get("prerouted"), launches=main_launches, **host,
        n_work=stats.get("work_units"), pops=stats.get("pops"),
        rank_rows=stats.get("rank_rows"),
        frame_rd_rows=stats.get("frame_rd_rows"),
        frame_wr_rows=stats.get("frame_wr_rows"), tiers=stats.get("tiers"),
        peak_device_gb=peak_gb, gold_seconds=round(t_gold, 1),
        parity_against="whole file, native gold engine",
        same_as_cli=same_as_cli, parity=parity, card=card)
    if reduced:
        main["reduced"] = reduced
    emit("main_path", ok=bool(parity and same_as_cli and main_launches > 0),
         **main)
    if not (parity and same_as_cli):
        fail("main_path", "`.aln` differs from the gold engine's or the "
                          "CLI's")
    if main_launches == 0 or stats.get("launches") != main_launches:
        fail("main_path", "the main path did not launch ring_search")

    # one try of torch.profiler over the same call: the ring kernel's
    # device time and the card's own busy share of the call (the union of
    # the device activities' intervals over the call's wall time, profiler
    # overhead included)
    try:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.time()
            align_reads_device(idx, didx, reads, params, cfg, d_cap=64,
                               queued=True, qchunk=16, stats={}, device=dev)
            torch.cuda.synchronize()
            wall = time.time() - t
        spans, ring_us = [], 0.0
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                spans.append((e.time_range.start, e.time_range.end))
                if "ring_search_kernel" in e.name:
                    ring_us += e.time_range.elapsed_us()
        busy_us, end = 0.0, None
        for a_, b_ in sorted(spans):
            if end is None or a_ > end:
                busy_us += b_ - a_
                end = b_
            elif b_ > end:
                busy_us += b_ - end
                end = b_
        emit("main_path.profile", ok=True, device_events=len(spans),
             ring_kernel_device_ms=ring_us / 1e3 if spans else None,
             device_busy_ms=busy_us / 1e3 if spans else None,
             wall_seconds=wall,
             device_busy_share=busy_us / 1e6 / wall if spans else None,
             t_search_of_timed_run=stats.get("t_search"), card=card)
    except Exception as ex:                      # report it, and go on
        emit("main_path.profile", ok=False, error=repr(ex)[:500])

    def path_line(n_reads, dt, stats, launches, **extra):
        """The common numbers of one driven path."""
        return dict(
            reads=n_reads, seconds=dt, reads_per_sec=n_reads / dt,
            t_dbounds=stats.get("t_dbounds"), t_search=stats.get("t_search"),
            t_host=stats.get("t_host"),
            streamed=bool(stats.get("streamed")), tiers=stats.get("tiers"),
            fallback_reads=stats.get("fallback_reads"),
            retried_reads=stats.get("retried_reads"),
            prerouted=stats.get("prerouted"), launches=launches,
            **{k: stats.get(k) for k in ("cpu_seconds", "gc_seconds",
                                         "loadavg_1min")},
            n_work=stats.get("work_units"), pops=stats.get("pops"),
            rank_rows=stats.get("rank_rows"),
            frame_rd_rows=stats.get("frame_rd_rows"),
            frame_wr_rows=stats.get("frame_wr_rows"),
            chain_work=stats.get("chain_work"), card=card, **extra)

    def zero_launches():
        for k in kernel.LAUNCHES:
            kernel.LAUNCHES[k] = 0

    def timed_align(idx_, didx_, reads_, params_, cfg_, **kw):
        """One in-process align_reads_device call: (alns, seconds, stats,
        launches by entry, peak device GB)."""
        st: dict = {}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_launches()
        mark = host_mark()
        t0 = time.time()
        out = align_reads_device(idx_, didx_, reads_, params_, cfg_,
                                 stats=st, device=dev, **kw)
        torch.cuda.synchronize()
        dt = time.time() - t0
        st.update(host_since(mark))
        return (out, dt, st, dict(kernel.LAUNCHES),
                torch.cuda.max_memory_allocated() / 1e9)

    # ------------------------------------------------------------ fixed path
    # what the quick start types: no --queued, default --batch 2048 and
    # --arena 32768, on the world and reads of the main path
    fixed_cli_aln = os.path.join(wdir, "fixed_cli.aln")
    zero_launches()
    rc, t_cli = timed_cli(["align", "-n", "4", "-t", str(threads), fa, fq,
                           fixed_cli_aln])
    cli_launches = dict(kernel.LAUNCHES)
    if rc != 0 or cli_launches["fixed_search"] == 0:
        fail("fixed_path", f"CLI align rc={rc} launches={cli_launches}")
    if not filecmp.cmp(fixed_cli_aln, gold_aln, shallow=False):
        fail("fixed_path", "the CLI's `.aln` differs from the gold engine's")
    p_fixed = AlnParams(max_diff=4, n_threads=threads)
    cfg_fixed = EngineConfig(cap=int(p_fixed.arena_cap))
    f_alns, f_dt, f_stats, f_launches, f_peak = timed_align(
        idx, didx, reads, p_fixed, cfg_fixed)
    fixed_aln = os.path.join(wdir, "fixed.aln")
    write_aln_file(fixed_aln, f_alns)
    f_parity = filecmp.cmp(fixed_aln, gold_aln, shallow=False)
    f_ok = bool(f_parity and f_launches["fixed_search"] > 0
                and f_stats.get("launches") == f_launches["fixed_search"])
    fixed_cli_seconds = t_cli
    emit("fixed_path", ok=f_ok, parity=f_parity, cli_seconds=round(t_cli, 1),
         cli_launches=cli_launches["fixed_search"],
         batch=int(p_fixed.batch_size), cap=int(cfg_fixed.cap),
         peak_device_gb=f_peak,
         parity_against="whole file, native gold engine",
         **path_line(reads.count, f_dt, f_stats,
                     f_launches["fixed_search"]))
    if not f_ok:
        fail("fixed_path", "`.aln` differs from the gold engine's, or the "
                           "path did not launch fixed_search")

    # kernel vs plain version on reads of the main world, at the main
    # path's read length and index with reduced arenas (the plain version
    # takes one lockstep iteration per pop of the longest read), twice:
    # at the first launch's settings (512 lanes, acap 24), and at the deep
    # rung's (128 lanes, acap 64, a larger arena) on the reads the first
    # left over their budget, topped up with the reads that follow.  Both
    # have more reads than lanes, so lanes refill from the queue.  Each
    # line prints the share of its reads that finish inside the arena.
    n_cmp, n_deep = 768, 256
    rd_c = worlds.head_reads(reads, n_cmp + n_deep)
    Dc = np.zeros((rd_c.count, rd_c.max_len + 1, 2), dtype=np.int32)
    Dsc = np.zeros((rd_c.count, int(params.seed_length) + 1, 2),
                   dtype=np.int32)
    for gi, Dch, Dsch, _z in native_scan_chunks(idx, rd_c, params, 512):
        Dc[gi[0]:gi[-1] + 1], Dsc[gi[0]:gi[-1] + 1] = Dch, Dsch
    rc_c = np.asarray(rd_c.rc, dtype=np.int8)
    c = compare("main_world", didx, rc_c[:n_cmp], rd_c.lengths[:n_cmp],
                Dc[:n_cmp], Dsc[:n_cmp], params,
                EngineConfig(cap=65536, acap=24, kx=2, max_iters=500_000,
                             xcap=128), 512)
    sel = np.concatenate([np.flatnonzero(c["over"]),
                          np.arange(n_cmp, n_cmp + n_deep)])[:n_deep]
    compare("main_world_deep", didx, rc_c[sel], rd_c.lengths[sel],
                 Dc[sel], Dsc[sel], params,
                 EngineConfig(cap=131072, acap=64, kx=2, max_iters=500_000,
                              xcap=128), 128)

    # the fixed-batch search at the fixed path's settings, un-cut: the
    # first tier's (one lane per read, the CLI's default arena, lists of
    # 128 intervals), then the deep tier's (256 lanes, the arena and work
    # bound the pipeline derives for it, acap 64) on the reads the first
    # left over their budget, topped up with the reads that follow
    cfg_tier1 = dataclasses.replace(cfg_fixed, xcap=128)
    cf = compare("main_world_fixed", didx, rc_c[:n_cmp],
                 rd_c.lengths[:n_cmp], Dc[:n_cmp], Dsc[:n_cmp], params,
                 cfg_tier1, None)
    deep_B, deep_kx = LADDER[0]
    sel = np.concatenate([np.flatnonzero(cf["over"]),
                          np.arange(n_cmp, n_cmp + n_deep)])[:deep_B]
    compare("main_world_fixed_deep", didx, rc_c[sel], rd_c.lengths[sel],
            Dc[sel], Dsc[sel], params,
            deep_tier_cfg(cfg_tier1, int(p_fixed.batch_size), deep_B,
                          deep_kx), None)

    # (d) seeded roots at the main world's IUPAC density: comparison A's
    # reads, seeded from a precalc_len-10 table of the main world built on
    # the card in memory (short k-mers there have hundreds of intervals on
    # the way to level 10, hence the list capacity K), 32 seed slots; the
    # ring at A's settings and the fixed launch at tier 1's
    p_d = dataclasses.replace(params, precalc_len=10, use_precalc=True)
    st_d: dict = {}
    t = time.time()
    table_d = build_precalc_device(idx, didx, p_d, k=10, K=1024,
                                   max_level_full=8, sub_batch=4096,
                                   device=dev, stats=st_d)
    emit("kernels.main_world_table", k=10, K=1024,
         seconds=round(time.time() - t, 1), intervals=int(table_d.L.shape[0]),
         overflow_entries=st_d["overflow_entries"],
         max_intervals=int(table_d.cnt.max()))
    rd_d = worlds.head_reads(rd_c, n_cmp)
    seeded_pair("main_world", didx, rd_d, Dc[:n_cmp], Dsc[:n_cmp], p_d,
                EngineConfig(cap=65536, acap=24, kx=2, max_iters=500_000,
                             xcap=128), table_d, 32, 512,
                cfg_fixed=cfg_tier1)
    del table_d

    # ------------------------------------------------------------- mesh path
    # `align -n 4 --mesh 1` through the CLI on fixed_path's world and reads:
    # the fixed tiers over a mesh of the one card (dp = tp = 1), which
    # runs no gold pool and no streamed branch, so D comes from the device
    # pass at d_cap and the native scanner for the reads that overflow it
    # (engine/pipeline.py's mesh branches); then one launch of
    # sharded_inexact_search against inexact_search on the same inputs
    mesh_aln = os.path.join(wdir, "mesh_cli.aln")
    zero_launches()
    rc, t_mesh, m_stats, m_dt = cli_with_stats(
        ["align", "-n", "4", "-t", str(threads), "--mesh", "1", fa, fq,
         mesh_aln])
    m_launches = dict(kernel.LAUNCHES)
    m_same = rc == 0 and filecmp.cmp(mesh_aln, fixed_cli_aln, shallow=False)
    tm_one = LaunchEvents()
    one = inexact_search(didx, rc_c[:n_cmp], rd_c.lengths[:n_cmp],
                         Dc[:n_cmp], Dsc[:n_cmp], params, cfg_tier1,
                         device=dev, timer=tm_one)
    shd = sharded_inexact_search(make_mesh(1), didx, rc_c[:n_cmp],
                                 rd_c.lengths[:n_cmp], Dc[:n_cmp],
                                 Dsc[:n_cmp], params, cfg_tier1)
    # the arena's rows past what a lane wrote are uninitialised scratch
    m_equal = all(torch.equal(one[k], shd[k]) for k in one if k != "arena")
    m_ok = bool(m_same and m_equal and m_launches["fixed_search"] > 0
                and m_stats.get("launches") == m_launches["fixed_search"])
    emit("mesh_path", ok=m_ok, same_as_fixed_path=m_same,
         sharded_equals_unsharded=m_equal, launch_reads=n_cmp,
         mesh={"dp": 1, "tp": 1}, cli_seconds=t_mesh,
         fixed_cli_seconds=fixed_cli_seconds,
         **path_line(reads.count, m_dt, m_stats,
                     m_launches["fixed_search"]))
    if not m_ok:
        fail("mesh_path", "`.aln` differs from fixed_path's, the sharded "
                          "launch differs from the unsharded one, or the "
                          "path did not launch fixed_search")
    del shd

    # --------------------------------------------------------------- tp path
    # `--mesh 1,2` and `--mesh 2,2` on the one card: the index range-sharded
    # over a mesh row that names cuda:0 two times (and, at (2, 2), over
    # each of two such rows), in-process through align_reads_device at
    # fixed_path's settings on its world and reads (-n 4, --batch 2048,
    # --arena 32768, -t), as the CLI's `--mesh` runs it: the sharded fixed
    # kernel at tp = 1's settings; each `.aln` byte-equal to fixed_path's
    # CLI `.aln`, every launch a sharded one.  Then one launch of
    # sharded_inexact_search at (1, 2) on mesh_path's main-world reads
    # against mesh_path's unsharded launch on them, every field but the
    # arena, both timed by their events
    tp_runs: dict = {}
    for dp_, tp_ in ((1, 2), (2, 2)):
        mesh_ = make_mesh(dp_, tp_, [dev0] * (dp_ * tp_))
        t_alns, t_dt, t_stats, t_launches, t_peak = timed_align(
            idx, didx, reads, p_fixed, cfg_fixed, mesh=mesh_)
        tp_aln = os.path.join(wdir, f"tp_{dp_}x{tp_}.aln")
        write_aln_file(tp_aln, t_alns)
        del t_alns
        t_same = filecmp.cmp(tp_aln, fixed_cli_aln, shallow=False)
        n_tp = t_launches["fixed_search_tp"]
        # a dispatch of the pipeline launches once a dp member
        t_ok = bool(t_same and n_tp > 0
                    and sum(t_launches.values()) == n_tp
                    and t_stats.get("launches", 0) * dp_ == n_tp)
        tp_runs[(dp_, tp_)] = (t_stats, n_tp)
        emit("tp_path", ok=t_ok, same_as_fixed_path=t_same, dp=dp_, tp=tp_,
             cards=1, shard_rows=mesh_.place(didx)[0].tp_tables[0].shape[0],
             table_rows=didx.num_blocks, tp_launches=n_tp,
             dispatches=t_stats.get("launches"), peak_device_gb=t_peak,
             mesh_path_seconds=m_dt,
             **path_line(reads.count, t_dt, t_stats, n_tp))
        if not t_ok:
            fail("tp_path", f"mesh ({dp_}, {tp_}): `.aln` differs from "
                            "fixed_path's, or not every launch was a "
                            f"sharded one: {t_launches}")
        del mesh_
    tm_shd = LaunchEvents()
    shd = sharded_inexact_search(make_mesh(1, 2, [dev0] * 2), didx,
                                 rc_c[:n_cmp], rd_c.lengths[:n_cmp],
                                 Dc[:n_cmp], Dsc[:n_cmp], params, cfg_tier1,
                                 timers=[tm_shd])
    torch.cuda.synchronize()
    t_equal = all(torch.equal(one[k], shd[k]) for k in one if k != "arena")
    # the whole align step on those reads (D pass, search, SA resolution of
    # each first alignment through the shards) at (2, 2) against (1, 1),
    # on the main index with its SA samples (loaded only here)
    didx_sa = dataclasses.replace(didx, sa_samples=torch.from_numpy(
        np.array(FMIndex.load(fa + ".bwt", load_sa=True).sa,
                 dtype=np.int32)).to(dev0))
    seq_c = np.asarray(rd_c.seq, dtype=np.int8)[:n_cmp]
    steps = [sharded_align_step(make_mesh(dp_, tp_, [dev0] * (dp_ * tp_)),
                                didx_sa, seq_c, rc_c[:n_cmp],
                                rd_c.lengths[:n_cmp], params, cfg_tier1)
             for dp_, tp_ in ((1, 1), (2, 2))]
    s_equal = all(torch.equal(steps[0][k], steps[1][k]) for k in steps[0]
                  if k != "arena")
    emit("tp_path.launch", ok=t_equal and s_equal,
         sharded_equals_unsharded=t_equal, mesh={"dp": 1, "tp": 2},
         reads=n_cmp,
         sharded_ms=tm_shd.events[0].elapsed_time(tm_shd.events[1]),
         unsharded_ms=tm_one.events[0].elapsed_time(tm_one.events[1]),
         align_step_2x2_equals_1x1=s_equal,
         ref_pos_resolved=int((steps[1]["ref_pos"] >= 0).sum()), card=card)
    if not (t_equal and s_equal):
        fail("tp_path", "the sharded launch differs from the unsharded one, "
                        "or the align step at (2, 2) from (1, 1)")
    del one, shd, steps, didx_sa
    # the sharded fixed kernel against its plain version on the same
    # sharded index at tier 1's settings, on those reads
    cft = compare("main_world_fixed", sharded(didx, 2), rc_c[:n_cmp],
                  rd_c.lengths[:n_cmp], Dc[:n_cmp], Dsc[:n_cmp], params,
                  cfg_tier1, None)

    # ------------------------------------------------------------ mesh cards
    mesh_cards(fa, fq, wdir, fixed_cli_aln, fixed_cli_seconds, threads, card)

    # ------------------------------------------------------------- dist path
    # two `--dist` processes on the one card, each with half of
    # fixed_path's -t, through the CLI's entry point; each prints its
    # launch counts, which start at 0 in a fresh process
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    dist_aln = os.path.join(wdir, "dist.aln")
    half = str(max(1, threads // 2))
    child = ("import json, sys; from bwbble_tpu_torch import cli; "
             "from bwbble_tpu_torch.engine import kernel; "
             "code = cli.main(sys.argv[1:]); "
             "print('LAUNCHES ' + json.dumps(kernel.LAUNCHES)); "
             "sys.exit(code)")
    t = time.time()
    procs = [subprocess.Popen(
        [sys.executable, "-c", child, "align", "-n", "4", "-t", half,
         "--dist", f"127.0.0.1:{port},2,{r}", fa, fq, dist_aln],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    try:
        outs = [p_.communicate(timeout=600) for p_ in procs]
    finally:
        for p_ in procs:
            if p_.poll() is None:
                p_.kill()
                p_.wait()
    d_wall = time.time() - t
    d_launches, d_align = 0, []
    for out, _err in outs:
        for ln_ in out.splitlines():
            if ln_.startswith("LAUNCHES "):
                d_launches += json.loads(ln_[9:])["fixed_search"]
            elif ln_.startswith("Total read alignment time:"):
                d_align.append(float(ln_.split()[-2]))
    d_rcs = [p_.returncode for p_ in procs]
    d_same = d_rcs == [0, 0] and filecmp.cmp(dist_aln, fixed_cli_aln,
                                             shallow=False)
    d_ok = bool(d_same and d_launches > 0)
    emit("dist_path", ok=d_ok, same_as_fixed_path=d_same, returncodes=d_rcs,
         processes=2, threads_each=int(half), reads=reads.count,
         wall_seconds=d_wall, align_seconds_each=d_align,
         fixed_cli_seconds=fixed_cli_seconds, launches=d_launches,
         card=card)
    if not d_ok:
        fail("dist_path", "the merged `.aln` differs from fixed_path's, a "
                          "process failed, or no process launched "
                          "fixed_search: " + " | ".join(
                              e[-500:] for _o, e in outs))

    # ------------------------------------------------------------- easy path
    # the easy world in fixed batches of 8 192: pure-ACGT genome, 16 384
    # reads of 100 bp with 2 mismatches, multi-genome mode
    edir = os.path.join(args.workdir, "easy")
    efa, efq = worlds.easy_world(edir, num_reads=NUM_READS)
    t = time.time()
    if cli.main(["index", efa]) != 0:
        fail("easy_path", "index failed")
    t_eindex = time.time() - t
    eidx = FMIndex.load(efa + ".bwt", load_sa=False)
    ereads = read_fastq(efq)
    edidx = from_fmindex(eidx, device=dev)
    p_easy = AlnParams(max_diff=4, batch_size=8192, n_threads=threads)
    cfg_easy = EngineConfig(cap=32768, acap=24, kx=2, max_iters=500_000)
    timed_align(eidx, edidx, worlds.head_reads(ereads, 256), p_easy,
                cfg_easy, d_cap=16)                           # warm-up
    e_alns, e_dt, e_stats, e_launches, e_peak = timed_align(
        eidx, edidx, ereads, p_easy, cfg_easy, d_cap=16, queued=False)
    easy_aln = os.path.join(edir, "easy.aln")
    write_aln_file(easy_aln, e_alns)
    t = time.time()
    egold = gold_fallback_many(eidx, ereads, list(range(ereads.count)),
                               p_easy, None, threads)
    easy_gold_aln = os.path.join(edir, "gold.aln")
    write_aln_file(easy_gold_aln, [egold[i] for i in range(ereads.count)])
    t_egold = time.time() - t
    e_parity = filecmp.cmp(easy_aln, easy_gold_aln, shallow=False)
    e_ok = bool(e_parity and e_launches["fixed_search"] > 0)
    emit("easy_path", ok=e_ok, parity=e_parity,
         index_seconds=round(t_eindex, 1), index_len=int(eidx.length),
         aligned=sum(1 for a in e_alns if a), peak_device_gb=e_peak,
         gold_seconds=round(t_egold, 1),
         parity_against="whole file, native gold engine",
         **path_line(ereads.count, e_dt, e_stats,
                     e_launches["fixed_search"]))
    if not e_ok:
        fail("easy_path", "`.aln` differs from the gold engine's, or the "
                          "path did not launch fixed_search")

    # ----------------------------------------------------------- single path
    # the same world as a plain 4-letter reference (-S): through the CLI,
    # then in-process and timed; the gold engine of -S is Python, so a
    # fixed sample is held against it and the whole file against a second
    # search path (the ring queue at 512 lanes)
    single_cli_aln = os.path.join(edir, "single_cli.aln")
    zero_launches()
    rc, t_scli = timed_cli(["align", "-n", "4", "-S", "-t", str(threads),
                            "--batch", "8192", efa, efq, single_cli_aln])
    s_cli_launches = dict(kernel.LAUNCHES)
    if rc != 0 or s_cli_launches["fixed_search"] == 0:
        fail("single_path", f"CLI align rc={rc} launches={s_cli_launches}")
    p_single = dataclasses.replace(p_easy, is_multiref=False)
    s_alns, s_dt, s_stats, s_launches, s_peak = timed_align(
        eidx, edidx, ereads, p_single, cfg_easy, d_cap=16, queued=False)
    single_aln = os.path.join(edir, "single.aln")
    write_aln_file(single_aln, s_alns)
    q_alns, q_dt, q_stats, q_launches, _ = timed_align(
        eidx, edidx, ereads, dataclasses.replace(p_single, batch_size=512),
        cfg_easy, d_cap=16, queued=True)
    single_q_aln = os.path.join(edir, "single_queued.aln")
    write_aln_file(single_q_aln, q_alns)
    n_gold = 128
    t = time.time()
    sgold = align_reads_gold(eidx, worlds.head_reads(ereads, n_gold),
                             p_single)
    t_sgold = time.time() - t
    s_gold_ok = all(sgold[i] == s_alns[i] for i in range(n_gold))
    s_parity = bool(
        s_gold_ok
        and filecmp.cmp(single_aln, single_q_aln, shallow=False)
        and filecmp.cmp(single_aln, single_cli_aln, shallow=False))
    s_ok = bool(s_parity and s_launches["fixed_search"] > 0
                and q_launches["ring_search"] > 0)
    emit("single_path", ok=s_ok, parity=s_parity,
         aligned=sum(1 for a in s_alns if a), peak_device_gb=s_peak,
         cli_seconds=round(t_scli, 1),
         cli_launches=s_cli_launches["fixed_search"],
         gold_sample_reads=n_gold, gold_sample_equal=s_gold_ok,
         gold_sample_seconds=round(t_sgold, 1),
         parity_against="first 128 reads: Python gold engine; whole file: "
                        "the queued search at 512 lanes, and the CLI's",
         queued_seconds=q_dt, queued_reads_per_sec=ereads.count / q_dt,
         queued_t_search=q_stats.get("t_search"),
         queued_launches=q_launches["ring_search"],
         queued_fallback_reads=q_stats.get("fallback_reads"),
         queued_cpu_seconds=q_stats.get("cpu_seconds"),
         **path_line(ereads.count, s_dt, s_stats,
                     s_launches["fixed_search"]))
    if not s_ok:
        fail("single_path", "`-S` outputs disagree, or a path did not "
                            "launch its kernel")

    # kernel vs plain version at what these two paths launch: one fixed
    # batch of 8 192 lanes in each alphabet, and one queued launch of the
    # single path's second run (512 lanes, two reads a lane), on the head
    # of the easy world's reads with the paths' arena and list capacities
    rd_e = worlds.head_reads(ereads, int(p_easy.batch_size))
    rc_e = np.asarray(rd_e.rc, dtype=np.int8)
    ln_e = rd_e.lengths.astype(np.int32)
    n_q = 2 * 512
    for tag, prm in (("easy", p_easy), ("easy_single", p_single)):
        De, Dse = device_d(edidx, rd_e, prm, 16)
        cfg_c = dataclasses.replace(cfg_easy,
                                    xcap=128 if prm.is_multiref else 0)
        compare(tag, edidx, rc_e, ln_e, De, Dse, prm, cfg_c, None)
        compare(tag, edidx, rc_e[:n_q], ln_e[:n_q], De[:n_q], Dse[:n_q],
                prm, cfg_c, 512)

    # --------------------------------------------------------------- precalc
    # the k = 12 seed table of the easy world, built on the card as `-P`
    # builds it at first use (align.c:59-66), written as `<fasta>.pre` (the
    # file the CLI reads below) and read back, and a fixed-seed sample of
    # its entries held against the gold engine's exact_match
    pre_file = efa + ".pre"
    if os.path.exists(pre_file):
        os.remove(pre_file)
    p_pre = AlnParams(max_diff=4, batch_size=8192, use_precalc=True,
                      n_threads=threads)
    k12 = int(p_pre.precalc_len)
    st_p: dict = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.time()
    table = build_precalc_device(eidx, edidx, p_pre, k=k12, device=dev,
                                 stats=st_p)
    torch.cuda.synchronize()
    t_build = time.time() - t
    build_peak = torch.cuda.max_memory_allocated() / 1e9
    t = time.time()
    store_pre(pre_file, table)
    t_store = time.time() - t
    t = time.time()
    back = load_pre(pre_file, num_entries=4 ** k12)
    t_load = time.time() - t
    round_trip = all(np.array_equal(getattr(back, f), getattr(table, f))
                     for f in ("cnt", "off", "L", "U"))
    del back
    sample = np.random.default_rng(12).choice(4 ** k12, 4096, replace=False)
    t = time.time()
    n_bad = 0
    for e in sample.tolist():
        digits = np.array([(e >> (2 * (k12 - 1 - q))) & 3
                           for q in range(k12)], dtype=np.int8)
        want = [tuple(iv) for iv in exact_match(eidx, digits, k12, p_pre)]
        n_bad += table[e] != want
    t_sample = time.time() - t
    pre_ok = bool(round_trip and n_bad == 0)
    emit("precalc", ok=pre_ok, k=k12, entries=4 ** k12,
         intervals=int(table.L.shape[0]),
         overflow_entries=st_p["overflow_entries"],
         seconds=round(t_build, 2), peak_device_gb=build_peak,
         store_seconds=round(t_store, 2), load_seconds=round(t_load, 2),
         file_bytes=os.path.getsize(pre_file), round_trip=round_trip,
         sample=int(sample.size),
         sample_nonempty=int((table.cnt[sample] > 0).sum()),
         sample_mismatched=n_bad, sample_seconds=round(t_sample, 1),
         card=card)
    if not pre_ok:
        fail("precalc", "the `.pre` round trip or the gold sample differs")

    # -------------------------------------------------------------- pre path
    # `bench.py --pre` (bench.py:226-228, :279-294): the easy world, fixed
    # batches of 8 192, seeded from the k = 12 table; in-process and timed,
    # then through the CLI (which reads the `.pre` written above), then
    # the queued search at 512 lanes over the same reads; the first
    # PRE_GOLD_READS reads against the Python gold engine (the only gold of
    # -P), on worker processes
    cfg_pre = EngineConfig(cap=32768, acap=24, kx=2, max_iters=500_000)
    timed_align(eidx, edidx, worlds.head_reads(ereads, 256), p_pre, cfg_pre,
                d_cap=16, precalc=table)                      # warm-up
    pr_alns, pr_dt, pr_stats, pr_launches, pr_peak = timed_align(
        eidx, edidx, ereads, p_pre, cfg_pre, d_cap=16, queued=False,
        precalc=table)
    pre_aln = os.path.join(edir, "pre.aln")
    write_aln_file(pre_aln, pr_alns)
    pre_cli_aln = os.path.join(edir, "pre_cli.aln")
    zero_launches()
    rc, t_pcli = timed_cli(["align", "-n", "4", "-P", "-t", str(threads),
                            "--batch", "8192", efa, efq, pre_cli_aln])
    p_cli_launches = dict(kernel.LAUNCHES)
    if rc != 0 or p_cli_launches["fixed_search_seeded"] == 0:
        fail("pre_path", f"CLI align -P rc={rc} launches={p_cli_launches}")
    pq_alns, pq_dt, pq_stats, pq_launches, _ = timed_align(
        eidx, edidx, ereads, dataclasses.replace(p_pre, batch_size=512),
        cfg_pre, d_cap=16, queued=True, precalc=table)
    pre_q_aln = os.path.join(edir, "pre_queued.aln")
    write_aln_file(pre_q_aln, pq_alns)
    head = worlds.head_reads(ereads, PRE_GOLD_READS)
    ri_h = read_indices(np.asarray(head.rc, dtype=np.int8),
                        head.lengths.astype(np.int32), k=k12)
    t = time.time()
    step = -(-head.count // threads)
    with ProcessPoolExecutor(
            threads,
            mp_context=multiprocessing.get_context("spawn")) as ex:
        futs = [ex.submit(
            _gold_job, efa + ".bwt", p_pre, head.seq[s0:s0 + step],
            head.rc[s0:s0 + step], head.lengths[s0:s0 + step],
            sorted(set(e for e in ri_h[s0:s0 + step].tolist() if e >= 0)))
            for s0 in range(0, head.count, step)]
        pgold = [a for f in futs for a in f.result()]
    t_pgold = time.time() - t
    pre_gold_ok = pgold == pr_alns[:head.count]
    pre_same_cli = filecmp.cmp(pre_aln, pre_cli_aln, shallow=False)
    pre_same_queued = filecmp.cmp(pre_aln, pre_q_aln, shallow=False)
    pre_parity = bool(pre_gold_ok and pre_same_cli and pre_same_queued)
    # under -P the gold pool's workers run the Python gold engine: spawned
    # processes, never threads
    pr_ok = bool(pre_parity and pr_launches["fixed_search_seeded"] > 0
                 and pq_launches["ring_search_seeded"] > 0
                 and pr_stats.get("gold_pool") == "processes"
                 and pq_stats.get("gold_pool") == "processes")
    emit("pre_path", ok=pr_ok, parity=pre_parity,
         same_as_cli=pre_same_cli, same_as_queued=pre_same_queued,
         gold_reads=head.count, gold_equal=pre_gold_ok,
         gold_seconds=round(t_pgold, 1), gold_reference_workers=threads,
         parity_against=f"first {head.count} reads: Python gold engine "
                        "with the same table; whole file: the CLI's and "
                        "the queued search's at 512 lanes",
         aligned=sum(1 for a in pr_alns if a), peak_device_gb=pr_peak,
         seed_slots=32, precalc_len=k12,
         seed_over_reads=pr_stats.get("seed_over_reads"),
         no_seed_hit_reads=pr_stats.get("no_seed_hit_reads"),
         root_rows=pr_stats.get("root_rows"),
         cli_seconds=round(t_pcli, 1),
         cli_launches=p_cli_launches["fixed_search_seeded"],
         queued_seconds=pq_dt, queued_reads_per_sec=ereads.count / pq_dt,
         queued_t_dbounds=pq_stats.get("t_dbounds"),
         queued_t_search=pq_stats.get("t_search"),
         queued_t_host=pq_stats.get("t_host"),
         **{f"{run}{k}": st_.get(k) for run, st_ in (("", pr_stats),
                                                    ("queued_", pq_stats))
            for k in ("gold_pool", "gold_workers", "gold_pool_start_s",
                      "gold_pool_shared_bytes")},
         queued_launches=pq_launches["ring_search_seeded"],
         queued_fallback_reads=pq_stats.get("fallback_reads"),
         **path_line(ereads.count, pr_dt, pr_stats,
                     pr_launches["fixed_search_seeded"]))
    if not pr_ok:
        fail("pre_path", "`-P` outputs disagree, a path did not launch "
                         "its seeded kernel, or its gold pool did not run "
                         "on processes")

    # (c) seeded comparisons at what pre_path launches: one fixed batch of
    # 8 192 lanes, and one queued launch of its second run (512 lanes, two
    # reads a lane), seeded from the k = 12 table, 32 seed slots
    De, Dse = device_d(edidx, rd_e, p_easy, 16)
    cfg_pc = dataclasses.replace(cfg_pre, xcap=128)
    sd_e, over_e = seeds_of(table, rd_e, k12, 32)
    c3 = compare("easy", edidx, rc_e, ln_e, De, Dse, p_pre, cfg_pc, None,
                 sd_e, over_e)
    compare("easy", edidx, rc_e[:n_q], ln_e[:n_q], De[:n_q], Dse[:n_q],
            p_pre, cfg_pc, 512, tuple(x[:n_q] for x in sd_e), over_e[:n_q])
    del table

    # ------------------------------------------------------------------- sam
    # stage 3 on the easy world's `.aln`: SA rows resolved on the card
    # against the host's per-row resolver
    sam_path = os.path.join(edir, "easy.sam")
    rc, t_sam = timed_cli(["aln2sam", "-n", "4", efa, efq, easy_aln,
                           sam_path])
    if rc != 0:
        fail("sam", "aln2sam failed")
    t = time.time()
    host_sam = alns_to_sam(FMIndex.load(efa + ".bwt", load_sa=True),
                           read_ann(efa + ".ann"), ereads,
                           read_aln_file(easy_aln), max_diff=4)
    t_host_sam = time.time() - t
    with open(sam_path) as f:
        sam_parity = f.read() == host_sam
    emit("sam", ok=sam_parity, parity=sam_parity, reads=ereads.count,
         records=host_sam.count("\n"), seconds=round(t_sam, 1),
         host_resolver_seconds=round(t_host_sam, 1), card=card)
    if not sam_parity:
        fail("sam", "SAM text differs from the host resolver's")

    # ---------------------------------------------------------------- probes
    # the three row-fetch probes through their entry points at their own
    # sizes (`python -m bwbble_tpu_torch.benchmarks.<probe>`), with the
    # launch counts set to 0 before and read after; then each kernel held
    # against its plain version on host copies of the same inputs (exact
    # equality), beside the one PyTorch call that computes the same
    # function where there is one
    for k_ in probe_k.LAUNCHES:
        probe_k.LAUNCHES[k_] = 0
    t = time.time()
    k4 = {b0: dma_probe.main([str(b0), "256"]) for b0 in (128, 512, 8192)}
    k5 = gather_pallas_probe.main()
    k6 = gather_bench.main()
    probe_launches = dict(probe_k.LAUNCHES)
    t_probes = time.time() - t
    for b0, rows in k4.items():
        for r in rows:
            emit("probes.dma_wave", variant=r["variant"], B0=b0, K=r["K"],
                 N=r["N"], ms=r["ms"], us_per_wave=r["us_per_wave"],
                 ns_per_row=r["ns_per_row"], card=card)
    for r in k5:
        emit("probes.digest_consume", variant=r["variant"], RQ=r["RQ"],
             B=r["B"], N=r["N"], layout=r["layout"], iters=r["iters"],
             ms=r["ms"], us_per_iter=r["us_per_iter"],
             ns_per_row=r["ns_per_row"], card=card)
    for r in k6:
        emit("probes.row_gather", variant=r["variant"], N=r["N"], ms=r["ms"],
             ns_per_row=r["ns_per_row"], equal=r["equal"], card=card)
    # ns a wave of `wave` at the main path's 512 lanes: the card's latency
    # of one dependent row fetch
    latency_ns = next(r for r in k4[512] if r["variant"] == "wave")[
        "ms"] * 1e6 / 256

    def latency_ms(chain_work):
        """Latency bound of launches whose busiest lanes did `chain_work`
        work units in all: each unit a round of dependent fetches."""
        return chain_work * latency_ns / 1e6
    emit("probes", ok=True, seconds=round(t_probes, 1),
         launches=probe_launches,
         latency_ns_per_dependent_row=latency_ns,
         latency_from="dma_wave, variant wave, B0 = 512, K = 256: ms a "
                      "launch / K", card=card)
    if min(probe_launches.values()) == 0 or not all(r["equal"] for r in k6):
        fail("probes", f"a probe kernel was not launched ({probe_launches})"
                       " or a gather differs from index_select")

    pcmps: dict = {"dma_wave": [], "digest_consume": [], "row_gather": []}

    def probe_compare(name, fn, plain, sets, nbytes, grid, library=None,
                      **what):
        """One probe kernel on the card against its plain version on host
        copies of the first of `sets` (argument tuples of distinct inputs).
        The kernel, the library call and the empty kernel of the kernel's
        `grid` (blocks, threads a block: the launch floor) are each timed
        with CUDA events around one replay of a CUDA graph of GRAPH_CALLS
        calls over the other sets, after a warm-up on the last, so the
        host's dispatch is not timed; the plain version on the host clock.
        The bound with the floor is the larger of it and the byte bound."""
        got = fn(*sets[0]).cpu()
        host = [x.cpu() if torch.is_tensor(x) else x for x in sets[0]]
        t0 = time.time()
        ref = plain(*host)
        plain_ms = (time.time() - t0) * 1e3
        err = int((got.to(torch.int64) - ref.to(torch.int64)).abs().max())
        ms = probe_k.time_graph(fn, sets, GRAPH_CALLS)
        bound = nbytes / PEAK_BYTES_S * 1e3
        floor = probe_k.time_graph(
            lambda *_a: probe_k.launch_floor(*grid, dev), sets, GRAPH_CALLS)
        line = dict(ms=ms, plain_ms=plain_ms,
                    library_ms=None if library is None else
                    probe_k.time_graph(library, sets, GRAPH_CALLS),
                    timed_by=f"CUDA graph of {GRAPH_CALLS} calls",
                    bound_ms=bound, bound_by="bytes", launch_grid=list(grid),
                    launch_floor_ms=floor,
                    bound_with_floor_ms=max(bound, floor),
                    time_over_bound_with_floor=ms / max(bound, floor),
                    max_abs_err=err, equal_to_plain=err == 0, **what)
        pcmps[name].append(line)
        emit("probes.compare", kernel=name, **line)
        if err:
            fail("probes", f"{name} {what} != its plain version")
        return line

    # every comparison is timed over SETS distinct input sets, one warms up,
    # in a graph of GRAPH_CALLS calls (K4's lightest launch, K5 and K6 take
    # a few microseconds, less than the host's dispatch of a call takes)
    SETS = 21
    GRAPH_CALLS = 200
    # K4: the probe's table (N rows of 512 bytes), B0 = 128 lanes for 16
    # waves, and the main path's 512 lanes for 256 waves, both variants.
    # Its bytes: of each row fetched, the words the output depends on (8
    # for `wave`, 32 for `compute`), idx0 read and the output written once
    tbl, idx_w = dma_probe.make_inputs(512, dma_probe.N, dev, seed=1,
                                       sets=SETS)
    for b0, kw in ((128, 16), (512, 256)):
        sets = [(i[:, :b0].contiguous(), tbl) for i in idx_w]
        for variant, heavy in dma_probe.VARIANTS:
            probe_compare(
                "dma_wave",
                lambda i, tb, k=kw, h=heavy: probe_k.dma_wave(
                    i, tb, k, h, check_index=False),
                lambda i, tb, k=kw, h=heavy: probe_k.dma_wave_plain(
                    i, tb, k, h),
                sets, b0 * kw * (128 if heavy else 32) + 2 * 8 * b0 * 4,
                probe_k.wave_grid(b0), variant=variant, B0=b0, K=kw,
                N=dma_probe.N)
    del tbl, idx_w, sets
    # K4's latency bound: K times the ns a wave of its lightest comparison
    # (`wave`, B0 = 128, K = 16; its time less the launch floor of its
    # grid, over its K), the least a chain of K dependent fetches takes on
    # this card
    k4_light = next(x for x in pcmps["dma_wave"]
                    if x["B0"] == 128 and x["variant"] == "wave")
    wave_ns = (k4_light["ms"] - k4_light["launch_floor_ms"]) * 1e6 / \
        k4_light["K"]
    for x in pcmps["dma_wave"]:
        x.update(latency_bound_ms=x["K"] * wave_ns / 1e6,
                 time_over_latency_bound=x["ms"] / (x["K"] * wave_ns / 1e6))
        emit("probes.latency_bound", kernel="dma_wave",
             variant=x["variant"], B0=x["B0"], K=x["K"], ms=x["ms"],
             latency_bound_ms=x["latency_bound_ms"],
             time_over_latency_bound=x["time_over_latency_bound"],
             ns_a_wave_from="wave, B0 = 128, K = 16, less its launch "
                            "floor", ns_a_wave=wave_ns,
             card=card)
    # K5: one iteration's rows of every variant, in its layout; the
    # library call is torch.sum over the digest view
    for variant, (rq, _w, layout) in gather_pallas_probe.VARIANTS.items():
        tb, k0 = gather_pallas_probe.make_inputs(variant, dev, seed=1)
        B_ = k0.shape[1]
        sets = [(gather_pallas_probe.gather_rows(variant, tb, k),)
                for k in [k0] + [torch.randint_like(k0, 0, tb.shape[0])
                                 for _ in range(SETS - 1)]]
        probe_compare(
            "digest_consume",
            lambda x_, l=layout, r=rq: probe_k.digest_consume(x_, l, r, B_),
            lambda x_, l=layout, r=rq: probe_k.digest_consume_plain(
                x_, l, r, B_),
            sets, rq * B_ * 8 * 4 + 8 * B_ * 4,
            probe_k.digest_grid(layout, B_),
            library=lambda x_, l=layout, r=rq: probe_k.digest_view(
                x_, l, r, B_).sum(dim=0, dtype=torch.int32),
            variant=variant, layout=layout, RQ=rq, B=B_)
        del tb, k0, sets
    # K6: both N, every variant; the library call is index_select.  The
    # launch shape the C side takes must be the one kernels.gather_shape
    # computes for the card's SMs and occupancy.  The table and the output
    # fit the 50 MB L2, so the rows may come from L2: beside the HBM byte
    # bound stands an L2 bound, the gather's bytes at the rate a contiguous
    # copy of its n rows reaches in the same harness
    for n_ in gather_bench.NS:
        tb, ks = gather_bench.make_inputs(gather_bench.NBLK, n_, dev, seed=1,
                                          sets=SETS)
        l2_copy_ms = probe_k.time_graph(lambda t_, k_, m=n_: t_[:m].clone(),
                                        [(tb, k) for k in ks], GRAPH_CALLS)
        l2_bound_ms = (n_ * 128 * 2 + n_ * 4) / (n_ * 128 * 2) * l2_copy_ms
        for variant, mode, unroll, nbuf in gather_bench.VARIANTS:
            shape, g_sms, g_bps = probe_k.gather_shape_on_card(
                n_, mode, unroll, nbuf)
            mirror = probe_k.gather_shape(n_, mode, unroll, nbuf, g_sms,
                                          g_bps)
            emit("probes.shape", kernel="row_gather", variant=variant, N=n_,
                 **shape._asdict(), sms=g_sms, blocks_per_sm=g_bps,
                 mirrors=shape == mirror)
            if shape != mirror or shape.smem > kernel.SMEM_MAX:
                fail("probes", f"row_gather {variant} N={n_}: the C shape "
                               f"{shape} is not kernels.gather_shape's "
                               f"{mirror}, or past {kernel.SMEM_MAX} bytes")
            probe_compare(
                "row_gather",
                lambda t_, k_, m=mode, u=unroll, b=nbuf: probe_k.row_gather(
                    t_, k_, m, u, b, check_index=False),
                lambda t_, k_, m=mode, u=unroll, b=nbuf:
                    probe_k.row_gather_plain(t_, k_, m, u, b),
                [(tb, k) for k in ks], n_ * 128 * 2 + n_ * 4,
                (shape.grid, shape.block),
                library=lambda t_, k_: t_.index_select(0, k_.long()),
                variant=variant, N=n_,
                NBLK=gather_bench.NBLK, l2_copy_ms=l2_copy_ms,
                l2_bound_ms=l2_bound_ms)
        del tb, ks
    # an index outside the table is refused on the card, before a launch
    tb = torch.zeros((16, 128), dtype=torch.int32, device=dev)
    bad = torch.full((8, 8), 16, dtype=torch.int32, device=dev)
    refused = 0
    for call in (lambda: probe_k.dma_wave(bad, tb, 2),
                 lambda: probe_k.row_gather(tb[:, :32].contiguous(), bad[0]),
                 lambda: probe_k.row_gather(tb[:, :32].contiguous(), -bad[0],
                                            "ring", nbuf=8)):
        try:
            call()
        except IndexError:
            refused += 1
    emit("probes.refusal", ok=refused == 3, refused=refused, of=3)
    if refused != 3:
        fail("probes", "a probe wrapper took an index outside its table")
    del tb, bad

    # ------------------------------------------------------------ int64 path
    # the int64 whole-genome layout (192-byte rows, int64 intervals and D)
    # through the fixed kernel's int64 instantiations: the main world's
    # index built in that layout, aligned as fixed_path aligns it (`align
    # -n 4`, default --batch and --arena, the same 8 192 reads); its `.aln`
    # must equal fixed_path's, which equals the gold engine's
    t = time.time()
    didx64 = from_fmindex(idx, use_int64=True, device=dev)
    torch.cuda.synchronize()
    t_build64 = time.time() - t
    i_alns, i_dt, i_stats, i_launches, i_peak = timed_align(
        idx, didx64, reads, p_fixed, cfg_fixed)
    i64_aln = os.path.join(wdir, "fixed_i64.aln")
    write_aln_file(i64_aln, i_alns)
    i_same = filecmp.cmp(i64_aln, fixed_aln, shallow=False)
    i_ok = bool(i_same and i_launches["fixed_search_i64"] > 0
                and i_launches["fixed_search"] == 0
                and i_stats.get("launches") == i_launches["fixed_search_i64"])
    i64_reduced = {
        "genome": "the main world (46.7 Mbp) in the int64 layout, not a "
                  "whole genome: a whole-genome index takes hours to build "
                  "on the host",
        "past_2^31": "checked on a virtual-offset index (counts and C "
                     "shifted by 3 * 2^32) of 2^16 blocks"}
    emit("int64_path", ok=i_ok, same_as_fixed_path=i_same,
         parity_against="fixed_path's `.aln` (itself equal to the gold "
                        "engine's), byte for byte",
         table_bytes=didx64.table.numel() * 4,
         layout_seconds=round(t_build64, 2), peak_device_gb=i_peak,
         i64_launches=i_launches["fixed_search_i64"], reduced=i64_reduced,
         **path_line(reads.count, i_dt, i_stats,
                     i_launches["fixed_search_i64"]))
    if not i_ok:
        fail("int64_path", "the int64 run's `.aln` differs from "
                           "fixed_path's, or it did not launch the int64 "
                           "instantiation (alone)")
    # the int64 fixed kernel against its plain version on 256 of the main
    # world's reads at tier 1's settings
    n_i64 = 256
    ci = compare("main_world_i64", didx64, rc_c[:n_i64],
                 rd_c.lengths[:n_i64], Dc[:n_i64].astype(np.int64),
                 Dsc[:n_i64].astype(np.int64), params, cfg_tier1, None)
    del didx64
    # past 2^31: a virtual-offset index (tests/test_int64.py) of 2^16
    # blocks: real in-block codes, every count and C shifted by 3 * 2^32;
    # the length stays 2^23 so that every rank query's clamped block lies
    # in the table.  rank_all_exact against a numpy int64 model, and the
    # int64 kernel against its plain version on 256 reads of 1-3 bases
    # (longer reads find only empty intervals on such an index): their
    # reported L/U lie past 2^33
    vrng = np.random.default_rng(3)
    OFF = 3 << 32
    nblk_v = 1 << 16
    vblocks = vrng.integers(0, 16, (nblk_v, 128)).astype(np.int8)
    vocc = vrng.integers(0, 100, (nblk_v, 16)).astype(np.int64) + OFF
    vtab = np.concatenate(
        [build_planes(vblocks),
         (vocc & 0xFFFFFFFF).astype(np.uint32).view(np.int32),
         (vocc >> 32).astype(np.int32)], axis=1)
    vcarr = np.arange(17, dtype=np.int64) * 7 + OFF
    vd = from_arrays(vtab, vcarr, np.zeros(4, np.int64), nblk_v * 128, 1,
                     device=dev)
    vpos = vrng.integers(0, nblk_v * 128 - 2, 4096).astype(np.int64)
    vgot = rank_all_exact(vd, torch.from_numpy(vpos).to(dev), 0).cpu().numpy()
    kb, ob = vpos // 128, vpos % 128
    vblk = vblocks[kb]
    sym = np.arange(16)
    vcnt = ((vblk[:, :, None] == sym) & (np.arange(128)[None, :, None]
                                         <= ob[:, None, None])).sum(axis=1)
    vexp = (vcarr[None, :16] + vocc[kb] + vcnt
            - (vblk[:, :1] == sym[None, :]).astype(np.int64))
    vexp[:, 0] = 0
    v_rank_ok = bool((vgot == vexp).all())
    vreads = parse_fastq_bytes("".join(
        f"@v{i}\n{s_}\n+\n{'I' * len(s_)}\n" for i, s_ in enumerate(
            "".join("ACGT"[x] for x in vrng.integers(0, 4, int(n)))
            for n in vrng.integers(1, 4, 256))).encode())
    cv = compare("virtual_offset_i64", vd, vreads.rc, vreads.lengths,
                 np.zeros((vreads.count, vreads.max_len + 1, 2), np.int64),
                 np.zeros((vreads.count, 33, 2), np.int64),
                 AlnParams(max_diff=1),
                 EngineConfig(cap=8192, acap=24, kx=2, max_iters=20_000,
                              xcap=16), None)
    # the same search on the table range-sharded over tp = 2 and tp = 3
    # (2^16 blocks: the last of three shards padded with two zero rows)
    for tp in (2, 3):
        compare("virtual_offset_i64", sharded(vd, tp), vreads.rc,
                vreads.lengths,
                np.zeros((vreads.count, vreads.max_len + 1, 2), np.int64),
                np.zeros((vreads.count, 33, 2), np.int64),
                AlnParams(max_diff=1),
                EngineConfig(cap=8192, acap=24, kx=2, max_iters=20_000,
                             xcap=16), None)
    v_high = int(cv["got"]["o_L"].max())
    emit("int64_path.virtual", ok=bool(v_rank_ok and v_high > 2**33),
         blocks=nblk_v, offset=OFF, rank_positions=int(vpos.size),
         rank_equal_to_numpy=v_rank_ok, search_reads=vreads.count,
         search_alignments=cv["n_alns"], reported_L_max=v_high)
    if not (v_rank_ok and v_high > 2**33 and cv["n_alns"] > 0):
        fail("int64_path", "the virtual-offset rank differs from the numpy "
                           "model, or its search reported nothing past 2^33")
    del vd

    # every plain version, then the comparison lines
    resolve_plain()

    def cmps_of(entry):
        return [x["line"] for x in cmps if x["line"]["entry"] == entry]

    def path_bound(st, x64=False):
        return bound_ms(dict(io_bytes=0, rank_rows=st["rank_rows"],
                             frame_rd=st["frame_rd_rows"],
                             frame_wr=st["frame_wr_rows"],
                             root_rd=st.get("root_rows", 0),
                             pops=st["pops"], x64=x64))[0]

    # the comparisons run every path's settings: their shapes are the
    # shapes the paths launch (a block is one lane)
    shapes = sorted({x["shape"] for x in cmps})
    emit("kernels.smem", launch_shapes=[
        dict(entry=e, NB=nb, Lmax=lm, DS=ds, XC=xc, smem_block_bytes=b)
        for e, nb, lm, ds, xc, b in shapes],
        max_block_bytes=max(x[-1] for x in shapes),
        limit_block_bytes=kernel.SMEM_MAX)

    def regs_of(*names):
        return {r["instantiation"]: r.get("registers") for r in regs
                if r["instantiation"] in names}

    def over_latency(ms, chain_work):
        lat = latency_ms(chain_work)
        return ms / lat if lat else None

    b_ms, b_by = bound_ms(c)
    fb_ms, fb_by = bound_ms(cf)
    sb_ms, sb_by = bound_ms(c3)
    ib_ms, ib_by = bound_ms(ci)
    i64_lines = cmps_of("fixed_search_i64") + cmps_of(
        "fixed_search_seeded_i64")
    tp_lines = [x["line"] for x in cmps if "_tp" in x["line"]["entry"]]
    tb_ms, tb_by = bound_ms(cft)
    tp_st, tp_n = tp_runs[(1, 2)]

    def probe_entry(name, source_replaces, replaces_name, main, **extra):
        """A probe kernel's entry: the numbers of its comparison `main`,
        every comparison, and the launches of the probes phase."""
        return {
            "name": name, "route": "cuda",
            "source": "bwbble_tpu_torch/csrc/probes.cu",
            "replaces": source_replaces, "replaces_name": replaces_name,
            "launches": probe_launches[name],
            "max_abs_err": max(x["max_abs_err"] for x in pcmps[name]),
            "equal_to_plain": all(x["equal_to_plain"]
                                  for x in pcmps[name]),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"], "at": {
                k: v for k, v in main.items() if k not in (
                    "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                    "max_abs_err", "equal_to_plain")},
            **extra, "comparisons": pcmps[name]}

    k4_main = next(x for x in pcmps["dma_wave"]
                   if x["B0"] == 512 and x["variant"] == "wave")
    k5_main = next(x for x in pcmps["digest_consume"]
                   if x["variant"] == "take")
    k6_main = next(x for x in pcmps["row_gather"]
                   if x["N"] == 65_536 and x["variant"] == "direct u1")
    seeded_lines = (cmps_of("fixed_search_seeded")
                    + cmps_of("ring_search_seeded"))
    src = "bwbble_tpu_torch/csrc/ring_search.cu"
    print(card, flush=True)
    print(json.dumps({"kernels": [{
        "name": "ring_search", "route": "cuda", "source": src,
        "replaces": "bwbble_tpu/engine/kernel.py:1127",
        "replaces_name": "_resident_kernel[ring] with _iter_math",
        "instantiations": ["<multiref, ring>", "<single, ring>"],
        "launches": main_launches, "max_abs_err": c["err"],
        "equal_to_plain": all(x["equal_to_plain"]
                              for x in cmps_of("ring_search")),
        "reads": c["reads"],
        "ms": c["ms"], "plain_ms": c["plain_ms"], "bound_ms": b_ms,
        "bound_by": b_by, "library_ms": None,
        "latency_bound_ms": c["line"]["latency_bound_ms"],
        # the same kernel over the main path's timed run (all launches)
        "main_path_ms": stats.get("t_search", 0.0) * 1e3,
        "main_path_bound_ms": path_bound(stats),
        "main_path_latency_bound_ms": latency_ms(stats["chain_work"]),
        "main_path_time_over_latency_bound": over_latency(
            stats.get("t_search", 0.0) * 1e3, stats["chain_work"]),
        "registers": regs_of("<multiref, ring, i32>", "<single, ring, i32>"),
        # the 4-letter instantiation over the queued run of the single path
        "single_path_launches": q_launches["ring_search"],
        "single_path_ms": q_stats.get("t_search", 0.0) * 1e3,
        "single_path_bound_ms": path_bound(q_stats),
        "single_path_latency_bound_ms": latency_ms(q_stats["chain_work"]),
        "comparisons": cmps_of("ring_search"),
    }, {
        "name": "fixed_search", "route": "cuda", "source": src,
        "replaces": "bwbble_tpu/engine/kernel.py:1127",
        "replaces_name": "_resident_kernel[fixed] via "
                         "run_loop_resident:1626",
        "instantiations": ["<multiref, fixed>", "<single, fixed>"],
        "launches": f_launches["fixed_search"], "max_abs_err": cf["err"],
        "equal_to_plain": all(x["equal_to_plain"]
                              for x in cmps_of("fixed_search")),
        "reads": cf["reads"],
        "ms": cf["ms"], "plain_ms": cf["plain_ms"], "bound_ms": fb_ms,
        "bound_by": fb_by, "library_ms": None,
        "latency_bound_ms": cf["line"]["latency_bound_ms"],
        # the same kernel over each path's timed run (all launches)
        "fixed_path_ms": f_stats.get("t_search", 0.0) * 1e3,
        "fixed_path_bound_ms": path_bound(f_stats),
        "fixed_path_latency_bound_ms": latency_ms(f_stats["chain_work"]),
        "fixed_path_time_over_latency_bound": over_latency(
            f_stats.get("t_search", 0.0) * 1e3, f_stats["chain_work"]),
        "easy_path_time_over_latency_bound": over_latency(
            e_stats.get("t_search", 0.0) * 1e3, e_stats["chain_work"]),
        "registers": regs_of("<multiref, fixed, i32>", "<single, fixed, i32>"),
        "easy_path_launches": e_launches["fixed_search"],
        "easy_path_ms": e_stats.get("t_search", 0.0) * 1e3,
        "easy_path_bound_ms": path_bound(e_stats),
        "easy_path_latency_bound_ms": latency_ms(e_stats["chain_work"]),
        "single_path_launches": s_launches["fixed_search"],
        "single_path_ms": s_stats.get("t_search", 0.0) * 1e3,
        "single_path_bound_ms": path_bound(s_stats),
        "single_path_latency_bound_ms": latency_ms(s_stats["chain_work"]),
        "comparisons": cmps_of("fixed_search"),
        # the int64 layout's instantiations: int64_path's timed run, and
        # comparison main_world_i64 (256 main-world reads at tier 1)
        "i64": {
            "instantiations": ["<multiref, fixed, i64>",
                               "<single, fixed, i64>"],
            "launches": i_launches["fixed_search_i64"],
            "max_abs_err": max(x["err"] for x in cmps
                               if x["line"] in i64_lines),
            "equal_to_plain": all(x["equal_to_plain"] for x in i64_lines),
            "reads": ci["reads"], "ms": ci["ms"],
            "plain_ms": ci["plain_ms"], "bound_ms": ib_ms,
            "bound_by": ib_by,
            "latency_bound_ms": ci["line"]["latency_bound_ms"],
            "int64_path_ms": i_stats.get("t_search", 0.0) * 1e3,
            "int64_path_bound_ms": path_bound(i_stats, x64=True),
            "int64_path_latency_bound_ms": latency_ms(i_stats["chain_work"]),
            "int64_path_time_over_latency_bound": over_latency(
                i_stats.get("t_search", 0.0) * 1e3, i_stats["chain_work"]),
            "registers": regs_of("<multiref, fixed, i64>",
                                 "<single, fixed, i64>"),
            "comparisons": i64_lines},
    }, {
        # K2 on a table range-sharded over tp (`--mesh DP,TP`): tp_path's
        # timed run at (1, 2) on one card, and comparison main_world_fixed
        # on the sharded index (768 main-world reads at tier 1)
        "name": "fixed_search_tp", "route": "cuda", "source": src,
        "replaces": "bwbble_tpu/engine/kernel.py:1127",
        "replaces_name": "_resident_kernel[fixed] via run_loop_resident:1626"
                         " on the tp shards of a mesh row (rows as the psum "
                         "of bwbble_tpu/engine/rank.py:41-55 gives them)",
        "entries": ["fixed_search_tp", "fixed_search_seeded_tp",
                    "fixed_search_tp_i64"],
        "instantiations": ["<multiref, fixed, i32, tp>",
                           "<single, fixed, i32, tp>",
                           "<multiref, fixed, i64, tp>",
                           "<single, fixed, i64, tp>"],
        "launches": tp_n, "launches_2x2": tp_runs[(2, 2)][1],
        "max_abs_err": max(x["err"] for x in cmps
                           if "_tp" in x["line"]["entry"]),
        "equal_to_plain": all(x["equal_to_plain"] for x in tp_lines),
        "reads": cft["reads"], "ms": cft["ms"], "plain_ms": cft["plain_ms"],
        "bound_ms": tb_ms, "bound_by": tb_by, "library_ms": None,
        "latency_bound_ms": cft["line"]["latency_bound_ms"],
        "unsharded_ms": cf["ms"],
        "tp_path_ms": tp_st.get("t_search", 0.0) * 1e3,
        "tp_path_bound_ms": path_bound(tp_st),
        "tp_path_latency_bound_ms": latency_ms(tp_st["chain_work"]),
        "tp_path_2x2_ms": tp_runs[(2, 2)][0].get("t_search", 0.0) * 1e3,
        "mesh_path_ms": m_stats.get("t_search", 0.0) * 1e3,
        "registers": regs_of("<multiref, fixed, i32, tp>",
                             "<single, fixed, i32, tp>",
                             "<multiref, fixed, i64, tp>",
                             "<single, fixed, i64, tp>"),
        "comparisons": tp_lines,
    }, {
        # K3's work: seeded roots in both entries of the same template
        "name": "seeded_search", "route": "cuda", "source": src,
        "replaces": "bwbble_tpu/engine/kernel.py:436 _kernel_body",
        "replaces_name": "_kernel_body (pallas_call :2203 in run_loop "
                         ":1978, seeded roots :2154-2162)",
        "entries": ["fixed_search_seeded", "ring_search_seeded"],
        "instantiations": ["<multiref, fixed>", "<multiref, ring>",
                           "<single, fixed>", "<single, ring>"],
        # pre_path's timed run: its fixed batches
        "launches": pr_launches["fixed_search_seeded"],
        "max_abs_err": max(x["err"] for x in cmps
                           if x["line"]["entry"].endswith("_seeded")),
        "equal_to_plain": all(x["equal_to_plain"] for x in seeded_lines),
        # comparison (c), pre_path's fixed batch of 8 192 lanes: its time,
        # bounds, the lanes an SM holds and the waves of them it needs
        "reads": c3["reads"],
        "ms": c3["ms"], "plain_ms": c3["plain_ms"], "bound_ms": sb_ms,
        "bound_by": sb_by, "library_ms": None,
        "latency_bound_ms": c3["line"]["latency_bound_ms"],
        "time_over_latency_bound": c3["line"]["time_over_latency_bound"],
        "resident_lanes_per_sm": c3["line"]["resident_lanes_per_sm"],
        "waves": c3["line"]["waves"],
        "registers": regs_of("<multiref, fixed, i32>",
                             "<multiref, ring, i32>"),
        "pre_path_ms": pr_stats.get("t_search", 0.0) * 1e3,
        "pre_path_bound_ms": path_bound(pr_stats),
        "pre_path_latency_bound_ms": latency_ms(pr_stats["chain_work"]),
        "pre_path_queued_launches": pq_launches["ring_search_seeded"],
        "pre_path_queued_ms": pq_stats.get("t_search", 0.0) * 1e3,
        "pre_path_queued_bound_ms": path_bound(pq_stats),
        "pre_path_queued_latency_bound_ms": latency_ms(
            pq_stats["chain_work"]),
        "comparisons": seeded_lines,
    },
        probe_entry("dma_wave", "benchmarks/dma_probe.py:99",
                    "_make (pallas_call :99, kernel :48)", k4_main,
                    latency_ns_per_dependent_row=latency_ns,
                    latency_bound_ms=k4_main["latency_bound_ms"],
                    time_over_latency_bound=k4_main[
                        "time_over_latency_bound"]),
        probe_entry("digest_consume", "benchmarks/gather_pallas_probe.py:50",
                    "consume :49, consume_rowmajor :103, run_pad128's "
                    "consume :157, run_pad128_grid's consume3 :195",
                    k5_main, launch_floor_ms=k5_main["launch_floor_ms"],
                    bound_with_floor_ms=k5_main["bound_with_floor_ms"]),
        probe_entry("row_gather", "benchmarks/gather_bench.py:56",
                    "gather_vmem :54 (_vmem_kernel :46), gather_hbm :101 "
                    "(_hbm_kernel :68)", k6_main,
                    launch_floor_ms=k6_main["launch_floor_ms"],
                    bound_with_floor_ms=k6_main["bound_with_floor_ms"],
                    l2_bound_ms=k6_main["l2_bound_ms"]),
    ]}), flush=True)
    last_line()
    return 0


if __name__ == "__main__":
    sys.exit(main())
