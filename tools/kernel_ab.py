"""Time versions of the search kernel's source against each other, in one
process on one card.

    python3 tools/kernel_ab.py SRC.cu [SRC.cu ...]
        [--genome-bp N] [--workdir DIR] [--repeats R]

Builds each source (nvcc, as engine/kernel.py:build does; one process a
source, started together), prints what `-Xptxas -v` says of each
instantiation (registers, stack, spills), and times each version, loaded as
the search library, on the main-path world's inputs (`worlds.chr21_world` as chip_smoke.py
builds it, D bounds from the native scan): the ring search of 768 reads at
512 lanes (comparison A), of 8 192 reads at 512 lanes (the main path's
first launch), fixed batches of 2 048 (the fixed path's tier 1) and 8 192
reads; and on the easy world's (`easy_world_inputs`): fixed batches of
8 192 reads unseeded and seeded (comparison (c)), and 1 024 reads at 512
lanes unseeded and seeded.  Each launch is timed by the events its C
launch records; the versions take turns, in alternating order, R times
(3), and every result must equal the first version's.  It prints the
lanes an SM holds for each.  Each source must keep the kernel's
C interface.  Fails on a card-less machine.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from bwbble_tpu_torch import build_native, cli, worlds
from bwbble_tpu_torch.align.params import AlnParams
from bwbble_tpu_torch.align.precalc import (build_precalc_device, load_pre,
                                            read_indices, store_pre)
from bwbble_tpu_torch.engine import kernel
from bwbble_tpu_torch.engine.device_index import from_fmindex
from bwbble_tpu_torch.engine.inexact import EngineConfig, ring_statics
from bwbble_tpu_torch.engine.dpass import chunk_bounds, native_scan_chunks
from bwbble_tpu_torch.formats.fastq import read_fastq
from bwbble_tpu_torch.index.fmindex import FMIndex
from chip_smoke import LaunchEvents, ptxas_report


def main_world_inputs(genome_bp: int, workdir: str, n_reads: int, dev):
    """The main-path world as chip_smoke.py builds it (`worlds.chr21_world`
    under `workdir`, indexed once) and the search inputs of its first
    `n_reads` reads on `dev`, D bounds from the native scan: (index on the
    device, params, [rc, lengths, D, Ds])."""
    build_native.build(verbose=False)
    wdir = os.path.join(workdir, f"chr21_{genome_bp}")
    fa, fq_all = worlds.chr21_world(wdir, genome_bp=genome_bp,
                                    num_reads=16_384, log=lambda m: None)
    if not os.path.exists(fa + ".bwt") and cli.main(["index", fa]) != 0:
        raise RuntimeError("index failed")
    idx = FMIndex.load(fa + ".bwt", load_sa=False)
    rd = worlds.head_reads(read_fastq(fq_all), n_reads)
    params = AlnParams(max_diff=4, batch_size=512, n_threads=8)
    D = np.zeros((rd.count, rd.max_len + 1, 2), dtype=np.int32)
    Ds = np.zeros((rd.count, int(params.seed_length) + 1, 2),
                  dtype=np.int32)
    for gi, Dch, Dsch, _z in native_scan_chunks(idx, rd, params, 512):
        D[gi[0]:gi[-1] + 1], Ds[gi[0]:gi[-1] + 1] = Dch, Dsch
    inputs = [torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in (
        np.asarray(rd.rc, dtype=np.int8), rd.lengths.astype(np.int32), D,
        Ds)]
    return from_fmindex(idx, device=dev), params, inputs


def easy_world_inputs(workdir: str, n_reads: int, dev, seeded: bool):
    """The easy world as chip_smoke.py builds it (`worlds.easy_world` under
    `workdir`/easy, indexed once) and the search inputs of its first
    `n_reads` reads on `dev` at pre_path's settings: D bounds from the
    device pass (lists of 16); with `seeded`, their seeds from the k = 12
    table (`bench.fa.pre` there, as chip_smoke.py writes it, else built on
    the card and written), 32 slots.  Returns (index on the device, params,
    [rc, lengths, D, Ds], (seed_L, seed_U, seed_cnt) or None)."""
    edir = os.path.join(workdir, "easy")
    fa, fq = worlds.easy_world(edir, num_reads=16_384)
    if not os.path.exists(fa + ".bwt") and cli.main(["index", fa]) != 0:
        raise RuntimeError("index failed")
    idx = FMIndex.load(fa + ".bwt", load_sa=False)
    didx = from_fmindex(idx, device=dev)
    rd = worlds.head_reads(read_fastq(fq), n_reads)
    params = AlnParams(max_diff=4, batch_size=8192, use_precalc=seeded)
    ln = rd.lengths.astype(np.int32)
    D, Ds, _over = chunk_bounds(didx, np.asarray(rd.seq, dtype=np.int8), ln,
                                params, 16)
    rc = np.asarray(rd.rc, dtype=np.int8)
    inputs = [torch.from_numpy(x).to(dev) for x in (rc, ln)] + [
        D.contiguous(), Ds.contiguous()]
    if not seeded:
        return didx, params, inputs, None
    k = int(params.precalc_len)
    if os.path.exists(fa + ".pre"):
        table = load_pre(fa + ".pre", num_entries=4 ** k)
    else:
        table = build_precalc_device(idx, didx, params, k=k, device=dev)
        store_pre(fa + ".pre", table)
    sL, sU, scnt, _ = table.lookup_batch(read_indices(rc, ln, k=k), 32)
    seeds = tuple(torch.from_numpy(x.astype(np.int32)).to(dev)
                  for x in (sL, sU, scnt))
    return didx, params, inputs, seeds


def kernel_ms(fn) -> tuple:
    """Call fn(timer) (one search launch) and wait for it: (its result, the
    milliseconds between the events the launch recorded)."""
    tm = LaunchEvents()
    out = fn(tm)
    torch.cuda.synchronize()
    return out, tm.events[0].elapsed_time(tm.events[1])


def same_results(a: dict, b: dict) -> bool:
    """Two launches' per-read results equal (the lane that served a read,
    and the arena, excepted)."""
    return all(torch.equal(v, b[k]) for k, v in a.items()
               if k not in ("o_lane", "arena"))


def main(argv: list[str]) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("sources", nargs="+")
    ap.add_argument("--genome-bp", type=int, default=46_700_000)
    ap.add_argument("--workdir", default=os.path.join(
        os.path.dirname(kernel.BUILD_DIR), ".bench_torch"))
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("kernel_ab runs on a CUDA device only")
    os.makedirs(kernel.BUILD_DIR, exist_ok=True)
    builds = {}
    for i, src in enumerate(args.sources):
        so = os.path.join(kernel.BUILD_DIR, f"libring_search_ab{i}.so")
        builds[src] = (so, subprocess.Popen(
            [kernel._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
             "-std=c++17", "-O3", "--expt-relaxed-constexpr", "-shared",
             "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", so, src],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    dev = torch.device("cuda")
    didx, params, inputs = main_world_inputs(args.genome_bp, args.workdir,
                                             8192, dev)
    edidx, p_easy, e_in, _ = easy_world_inputs(args.workdir, 8192, dev,
                                               seeded=False)
    _, p_pre, _, sd = easy_world_inputs(args.workdir, 8192, dev,
                                        seeded=True)

    def head(x, n):
        return [v[:n] for v in x]
    ring = EngineConfig(cap=65536, acap=24, kx=2, max_iters=500_000,
                        xcap=128)
    tier1 = EngineConfig(cap=32768, xcap=128)
    easy = EngineConfig(cap=32768, acap=24, kx=2, max_iters=500_000,
                        xcap=128)

    def st(p, cfg, a, seeds, fixed):
        return ring_statics(p, cfg, a[0].shape[1], a[3].shape[1],
                            fixed=fixed, seed_slots=0 if seeds is None
                            else seeds[0].shape[1])
    # (name, statics, run(timer))
    runs = (
        ("main ring 768 reads, 512 lanes (A)",
         st(params, ring, inputs, None, False),
         lambda tm: kernel.ring_search(didx, *head(inputs, 768), params,
                                       ring, 512, timer=tm)),
        ("main ring 8192 reads, 512 lanes",
         st(params, ring, inputs, None, False),
         lambda tm: kernel.ring_search(didx, *inputs, params, ring, 512,
                                       timer=tm)),
        ("main fixed 2048 (tier 1)", st(params, tier1, inputs, None, True),
         lambda tm: kernel.fixed_search(didx, *head(inputs, 2048), params,
                                        tier1, timer=tm)),
        ("main fixed 8192", st(params, tier1, inputs, None, True),
         lambda tm: kernel.fixed_search(didx, *inputs, params, tier1,
                                        timer=tm)),
        ("easy fixed 8192", st(p_easy, easy, e_in, None, True),
         lambda tm: kernel.fixed_search(edidx, *e_in, p_easy, easy,
                                        timer=tm)),
        ("easy seeded fixed 8192 (c)", st(p_pre, easy, e_in, sd, True),
         lambda tm: kernel.fixed_search(edidx, *e_in, p_pre, easy, sd,
                                        timer=tm)),
        ("easy ring 1024 reads, 512 lanes",
         st(p_easy, easy, e_in, None, False),
         lambda tm: kernel.ring_search(edidx, *head(e_in, 1024), p_easy,
                                       easy, 512, timer=tm)),
        ("easy seeded ring 1024 reads, 512 lanes",
         st(p_pre, easy, e_in, sd, False),
         lambda tm: kernel.ring_search(
             edidx, *head(e_in, 1024), p_pre, easy, 512,
             tuple(x[:1024] for x in sd), timer=tm)),
    )
    libs = {}
    for src, (so, proc) in builds.items():
        _out, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src}:\n{err[-3000:]}")
        print(json.dumps({"source": src, "ptxas": ptxas_report(
            err.splitlines())}), flush=True)
        libs[src] = ctypes.CDLL(so)
        kernel._bind_ring_search(libs[src])
    saved = kernel._libs.get("ring_search")
    ms: dict = {}
    ref: dict = {}
    occ: dict = {}
    try:
        for rep in range(args.repeats):
            order = args.sources if rep % 2 == 0 else args.sources[::-1]
            for src in order:
                kernel._libs["ring_search"] = libs[src]
                for name, S, fn in runs:
                    fn(None)
                    torch.cuda.synchronize()
                    got, t = kernel_ms(fn)
                    key = os.path.basename(src)
                    ms.setdefault(name, {}).setdefault(key, []).append(t)
                    if name not in ref:
                        ref[name] = got
                    elif not same_results(ref[name], got):
                        raise RuntimeError(f"{key}: {name} differs from "
                                           "the first version's results")
                    if rep == 0:
                        occ.setdefault(name, {})[key] = \
                            kernel.resident_lanes(S)
    finally:
        if saved is None:
            kernel._libs.pop("ring_search", None)
        else:
            kernel._libs["ring_search"] = saved
    out = dict(card=torch.cuda.get_device_name(0), ms=ms)
    for name in ms:
        print(json.dumps({"run": name, "ms": ms[name],
                          "resident_lanes_per_sm": occ[name]}), flush=True)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
