"""Time versions of the search kernel's source against each other, in one
process on one card.

    python3 tools/kernel_ab.py SRC.cu [SRC.cu ...]
        [--genome-bp N] [--workdir DIR] [--repeats R]

Builds each source (nvcc, as engine/kernel.py:build does; one process a
source, started together), prints what `-Xptxas -v` says of each
instantiation, and times each version, loaded as the search library, on the
same main-path world inputs (`worlds.chr21_world` as chip_smoke.py builds
it, D bounds from the native scan): the ring search of 768 reads at 512
lanes (comparison A), of 8 192 reads at 512 lanes (the main path's first
launch), and fixed batches of 2 048 (the fixed path's tier 1) and 8 192
reads.  The versions take turns, in alternating order, R times (3).  Each
source must keep the kernel's C interface.  Fails on a card-less machine.
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
from bwbble_tpu_torch.engine import kernel
from bwbble_tpu_torch.engine.device_index import from_fmindex
from bwbble_tpu_torch.engine.inexact import EngineConfig
from bwbble_tpu_torch.engine.pipeline import native_scan_chunks
from bwbble_tpu_torch.formats.fastq import read_fastq
from bwbble_tpu_torch.index.fmindex import FMIndex


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
    didx, params, inputs = main_world_inputs(
        args.genome_bp, args.workdir, 8192, torch.device("cuda"))

    def head(n):
        return [x[:n] for x in inputs]
    ring = EngineConfig(cap=65536, acap=24, kx=2, max_iters=500_000,
                        xcap=128)
    tier1 = EngineConfig(cap=32768, xcap=128)
    runs = (("ring 768 reads, 512 lanes", lambda: kernel.ring_search(
                didx, *head(768), params, ring, 512)),
            ("ring 8192 reads, 512 lanes", lambda: kernel.ring_search(
                didx, *head(8192), params, ring, 512)),
            ("fixed 2048", lambda: kernel.fixed_search(
                didx, *head(2048), params, tier1)),
            ("fixed 8192", lambda: kernel.fixed_search(
                didx, *head(8192), params, tier1)))
    libs = {}
    for src, (so, proc) in builds.items():
        _out, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src}:\n{err[-3000:]}")
        print(json.dumps({"source": src, "ptxas": [
            ln.split("ptxas info    : ")[-1].strip() for ln in
            err.splitlines() if "registers" in ln or "spill" in ln]}),
            flush=True)
        libs[src] = ctypes.CDLL(so)
        kernel._bind_ring_search(libs[src])
    saved = kernel._libs.get("ring_search")
    ms: dict = {}
    try:
        for rep in range(args.repeats):
            order = args.sources if rep % 2 == 0 else args.sources[::-1]
            for src in order:
                kernel._libs["ring_search"] = libs[src]
                for name, fn in runs:
                    fn()
                    torch.cuda.synchronize()
                    ev0 = torch.cuda.Event(enable_timing=True)
                    ev1 = torch.cuda.Event(enable_timing=True)
                    ev0.record()
                    fn()
                    ev1.record()
                    torch.cuda.synchronize()
                    ms.setdefault(name, {}).setdefault(src, []).append(
                        ev0.elapsed_time(ev1))
    finally:
        if saved is None:
            kernel._libs.pop("ring_search", None)
        else:
            kernel._libs["ring_search"] = saved
    out = dict(card=torch.cuda.get_device_name(0), ms=ms)
    for name in ms:
        print(json.dumps({"run": name, "ms": ms[name]}), flush=True)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
