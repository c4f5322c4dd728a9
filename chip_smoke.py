#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--genome-bp N] [--workdir DIR]

Drives the port's main path — `index`, then `align -n 4 --queued` on the
chr21-scale multi-genome world — through the entry points a user calls, and
holds every hand-written kernel against its plain PyTorch version on the
card.  Each phase prints one JSON line as it finishes; any failed phase makes
the exit code non-zero.  Without a CUDA device the script fails at once: it
has no CPU mode.  The last line is
{"ok": true, "device": {"platform": "gpu", "kind": "<card>", "count": N}}.

Phases: device, build (native C++ library and CUDA kernels, from the sources
in this checkout), kernels (kernel == plain version, exact equality, on the
two small test worlds and on reads of the main world, more reads than lanes,
at the settings of both of the main path's launches), main_path (CLI index +
align, then the timed in-process run; `.aln` byte-compared with the gold
engine's), then the `{"kernels": [...]}` line and the last line.
"""

from __future__ import annotations

import argparse
import filecmp
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
GENOME_BP = 46_700_000
NUM_READS = 16_384
BENCH_READS = 8_192
# published peaks of one H100 SXM: device memory rate, and the float32 rate
# outside the tensor cores taken as the rate of the kernel's integer work
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12
T0 = time.time()


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, "t": round(time.time() - T0, 1), **kw}),
          flush=True)


def fail(phase: str, why: str) -> None:
    emit(phase, ok=False, error=why)
    sys.exit(1)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--genome-bp", type=int, default=GENOME_BP)
    ap.add_argument("--workdir", default=os.path.join(ROOT, ".bench_torch"))
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
    from bwbble_tpu_torch.engine.device_index import from_fmindex
    from bwbble_tpu_torch.engine.inexact import (EngineConfig,
                                                 ring_search_plain)
    from bwbble_tpu_torch.engine.pipeline import (align_reads_device,
                                                  gold_fallback_many,
                                                  native_scan_chunks)
    from bwbble_tpu_torch.formats.aln import write_aln_file
    from bwbble_tpu_torch.formats.fastq import read_fastq
    from bwbble_tpu_torch.gold.engine import calculate_d
    from bwbble_tpu_torch.index.fmindex import FMIndex
    from bwbble_tpu_torch.native import get_native

    dev = torch.device("cuda")

    # ---------------------------------------------------------------- device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        and smi.stdout.strip() else "nvidia-smi unavailable"
    emit("device", card=card, torch=torch.__version__,
         cuda=torch.version.cuda, kind=torch.cuda.get_device_name(0))

    # ----------------------------------------------------------------- build
    t = time.time()
    nvcc = subprocess.Popen(
        [sys.executable, "-c",
         "from bwbble_tpu_torch.engine import kernel; print(kernel.build())"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        build_native.build(verbose=False)       # g++, alongside nvcc
    finally:
        k_out, k_err = nvcc.communicate()
    if nvcc.returncode != 0:
        fail("build", "kernel build failed: " + k_err[-2000:])
    nat = get_native()
    if nat is None or not nat._has_gold or not nat._has_calc_d:
        fail("build", "native library did not load")
    kernel._load()
    with open(k_out.strip() + ".log") as f:
        ptxas = [ln.strip() for ln in f if "registers" in ln
                 or "stack frame" in ln]
    emit("build", ok=True, seconds=round(time.time() - t, 1),
         kernel_lib=os.path.relpath(k_out.strip(), ROOT), ptxas=ptxas)

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

    def compare(name, didx, rc, lengths, D, Ds, params, cfg, lanes):
        """Kernel and plain version on the same device tensors: every
        per-read output, path, overflow flag and counter must be equal
        (integers: tolerance zero).  Returns times, counters and the
        per-read overflow flags."""
        a = [torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in
             (np.asarray(rc, dtype=np.int8), lengths.astype(np.int32),
              D, Ds)]
        n = a[0].shape[0]
        kernel.ring_search(didx, *a, params, cfg, lanes)      # warm-up
        torch.cuda.synchronize()
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        ev0.record()
        got = kernel.ring_search(didx, *a, params, cfg, lanes)
        ev1.record()
        torch.cuda.synchronize()
        ms = ev0.elapsed_time(ev1)
        # per-read results do not depend on the lane that serves a read,
        # so the plain version runs all reads as one lockstep chunk
        t0 = time.time()
        ref = ring_search_plain(didx, *a, params, cfg, n)
        torch.cuda.synchronize()
        plain_ms = (time.time() - t0) * 1e3
        bad, err = [], 0
        for k in ref:
            if k == "o_lane":            # which lane served a read: free
                continue
            d = (ref[k].to(torch.int64) - got[k].to(torch.int64)).abs()
            if int(d.max()) != 0:
                bad.append(k)
                err = max(err, int(d.max()))
        tot = {k: int(got[k].sum(dtype=torch.int64)) for k in
               ("n_work", "pops", "rank_rows", "frame_rd", "frame_wr",
                "n_alns", "overflow")}
        io_bytes = sum(x.numel() * x.element_size() for x in a) + sum(
            got[k].numel() * got[k].element_size()
            for k in ("o_L", "o_U", "o_score", "o_len", "o_node", "o_snp",
                      "o_plen", "paths", "n_alns", "overflow"))
        emit("kernels.compare", world=name, reads=n,
             lanes_used=min(lanes, n), refills=max(0, n - lanes),
             cap=cfg.cap, acap=cfg.acap, equal_to_plain=not bad,
             mismatched=bad, kernel_ms=ms, plain_ms=plain_ms, **tot)
        if bad:
            fail("kernels", f"ring_search != plain version on {name}: {bad}")
        return dict(ms=ms, plain_ms=plain_ms, err=err, io_bytes=io_bytes,
                    reads=n, over=got["overflow"].cpu().numpy(), **tot)

    def bound_ms(c):
        """Least time the card could take for the work these inputs need:
        the bytes moved (per-read inputs and outputs once, plus what the
        kernel's own counters say the search had to touch: 128-byte rank
        rows, 16-byte popped slots, at least one 16-byte slot and the
        parent word per written frame) over the memory rate, against the
        integer operations (about 16 per symbol word of a rank row's 11-16
        symbols, ~1000 a row; ~300 a pop) over the ALU rate."""
        nbytes = (c["io_bytes"] + 128 * c["rank_rows"] + 16 * c["frame_rd"]
                  + 20 * c["frame_wr"])
        ops = 1000 * c["rank_rows"] + 300 * c["pops"]
        tb, to = nbytes / PEAK_BYTES_S * 1e3, ops / PEAK_OPS_S * 1e3
        return max(tb, to), ("bytes" if tb >= to else "operations")

    p3 = AlnParams(max_diff=3, batch_size=128)
    idx_s, rd_s = worlds.mixed_world()
    D, Ds = exact_d(idx_s, rd_s, p3)
    didx_s = from_fmindex(idx_s, device=dev)
    cfg_s = EngineConfig(cap=4096, acap=24, kx=2, max_iters=20_000, xcap=128)
    compare("mixed", didx_s, rd_s.rc, rd_s.lengths, D, Ds, p3, cfg_s, 64)
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
    compare("iupac_dense", from_fmindex(idx_s, device=dev), rd_s.rc,
            rd_s.lengths, D, Ds, p3, EngineConfig(cap=8192, acap=24, kx=2, max_iters=60_000,
                         xcap=128), 32)

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
    t = time.time()
    rc = cli.main(["align", "-n", "4", "-t", str(threads), "--queued",
                   "--batch", "512", "--arena", "655360", fa, fq, cli_aln])
    torch.cuda.synchronize()
    t_cli = time.time() - t
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
    t = time.time()
    alns = align_reads_device(idx, didx, reads, params, cfg, d_cap=64,
                              queued=True, qchunk=16, stats=stats,
                              device=dev)
    torch.cuda.synchronize()
    dt = time.time() - t
    main_launches = kernel.LAUNCHES["ring_search"]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    dev_aln = os.path.join(wdir, "device.aln")
    write_aln_file(dev_aln, alns)
    same_as_cli = filecmp.cmp(dev_aln, cli_aln, shallow=False)

    # parity: the whole file against the gold engine (native, threaded)
    t = time.time()
    gold = gold_fallback_many(idx, reads, list(range(reads.count)), params,
                              threads)
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
        prerouted=stats.get("prerouted"), launches=main_launches,
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

    # kernel vs plain version on reads of the main world, at the main
    # path's read length and index with reduced arenas (the plain version
    # takes one lockstep iteration per pop of the longest read), twice:
    # at the first launch's settings (512 lanes, acap 24), and at the deep
    # rung's (128 lanes, acap 64, a larger arena) on the reads the first
    # left over their budget, topped up with the reads that follow.  Both
    # have more reads than lanes, so lanes refill from the queue.
    n_cmp, n_deep = 1024, 384
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
    cd = compare("main_world_deep", didx, rc_c[sel], rd_c.lengths[sel],
                 Dc[sel], Dsc[sel], params,
                 EngineConfig(cap=131072, acap=64, kx=2, max_iters=500_000,
                              xcap=128), 128)

    b_ms, b_by = bound_ms(c)
    main_c = dict(io_bytes=0, rank_rows=main["rank_rows"],
                  frame_rd=main["frame_rd_rows"],
                  frame_wr=main["frame_wr_rows"], pops=main["pops"])
    mb_ms, _ = bound_ms(main_c)
    print(card, flush=True)
    print(json.dumps({"kernels": [{
        "name": "ring_search", "route": "cuda",
        "source": "bwbble_tpu_torch/csrc/ring_search.cu",
        "replaces": "bwbble_tpu/engine/kernel.py:1127",
        "replaces_name": "_resident_kernel[ring] with _iter_math",
        "launches": main_launches, "max_abs_err": c["err"],
        "equal_to_plain": True, "reads": c["reads"],
        "ms": c["ms"], "plain_ms": c["plain_ms"], "bound_ms": b_ms,
        "bound_by": b_by, "library_ms": None,
        # the same kernel over the main path's timed run (all launches)
        "main_path_ms": stats.get("t_search", 0.0) * 1e3,
        "main_path_bound_ms": mb_ms,
        # the comparison at the deep rung's settings
        "deep_reads": cd["reads"], "deep_ms": cd["ms"],
        "deep_plain_ms": cd["plain_ms"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
