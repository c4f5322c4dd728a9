"""Time versions of the probe kernels' source against each other, in one
process on one card: the row gather (K6).

    python3 tools/probes_ab.py SRC.cu [SRC.cu ...] [--repeats R]
        [--out FILE]

Builds each source (nvcc, as engine/kernel.py:build does; one process a
source, started together) and prints what `-Xptxas -v` says of each kernel.
Then each version, loaded as the probes library, times `row_gather` on the
inputs chip_smoke.py's probes phase times it on: gather_bench's table
[78 125, 32] and 21 index sets (seed 1) at N = 16 384 and 65 536, every
variant, in a CUDA graph of 200 calls over 20 of the sets after a warm-up
on the 21st (`kernels.time_graph`).  `index_select` is timed the same way
once a round, and so is a contiguous copy of the table's first N rows
(`clone`): its rate, with source and destination in L2 as the gather's
are, gives an L2 bound for the gather's bytes.  A source that has
`probe_floor_launch` and `row_gather_shape` also times the empty kernel at
the grid of each of its launches (the launch floor).  The versions take
turns, in alternating order, R times (2); every result must equal
index_select's.  Each source must keep row_gather_launch's C interface.
Prints a JSON line a timing, then a summary line a (source, N, variant):
the least and the median ms; with --out, writes all of it there as JSON.
Fails on a card-less machine.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from bwbble_tpu_torch.benchmarks import gather_bench  # noqa: E402
from bwbble_tpu_torch.benchmarks import kernels as probe_k  # noqa: E402
from bwbble_tpu_torch.engine import kernel  # noqa: E402

SETS = 21
GRAPH_CALLS = 200


def _bind(lib: ctypes.CDLL) -> bool:
    """Bind the row gather's entry, and the floor's and the shape's where
    the source has them; True when it has them."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.row_gather_launch.argtypes = [vp, vp, vp, ci, ci, ci, ci, vp]
    lib.row_gather_launch.restype = ci
    if not (hasattr(lib, "probe_floor_launch")
            and hasattr(lib, "row_gather_shape")):
        return False
    lib.probe_floor_launch.argtypes = [ci, ci, vp]
    lib.row_gather_shape.argtypes = [ci, ci, ci, ci,
                                     ctypes.POINTER(ctypes.c_int)]
    lib.probe_floor_launch.restype = lib.row_gather_shape.restype = ci
    return True


def main(argv: list[str]) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("sources", nargs="+")
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("probes_ab runs on a CUDA device only")
    os.makedirs(kernel.BUILD_DIR, exist_ok=True)
    builds = {}
    for i, src in enumerate(args.sources):
        so = os.path.join(kernel.BUILD_DIR, f"libprobes_ab{i}.so")
        builds[src] = (so, subprocess.Popen(
            [kernel._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
             "-std=c++17", "-O3", "--expt-relaxed-constexpr", "-shared",
             "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", so, src],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        and smi.stdout.strip() else "nvidia-smi unavailable"
    print(card, flush=True)
    dev = torch.device("cuda")
    inputs = {n: gather_bench.make_inputs(gather_bench.NBLK, n, dev, seed=1,
                                          sets=SETS)
              for n in gather_bench.NS}
    libs, shaped = {}, {}
    for src, (so, proc) in builds.items():
        _out, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src}:\n{err[-3000:]}")
        print(json.dumps({"source": src, "ptxas": [
            ln.strip() for ln in err.splitlines()
            if "Compiling entry" in ln or "registers" in ln]}), flush=True)
        libs[src] = ctypes.CDLL(so)
        shaped[src] = _bind(libs[src])
    saved = kernel._libs.get("probes")
    lines: list[dict] = []

    def emit(**kw):
        lines.append(kw)
        print(json.dumps(kw), flush=True)
    try:
        for rep in range(args.repeats):
            order = args.sources if rep % 2 == 0 else args.sources[::-1]
            for n, (tb, ks) in inputs.items():
                sets = [(tb, k) for k in ks]
                emit(rep=rep, source="index_select", N=n, variant="library",
                     ms=probe_k.time_graph(
                         lambda t_, k_: t_.index_select(0, k_.long()), sets,
                         GRAPH_CALLS))
                emit(rep=rep, source="clone", N=n, variant="l2 copy",
                     ms=probe_k.time_graph(
                         lambda t_, k_, m=n: t_[:m].clone(), sets,
                         GRAPH_CALLS))
            for src in order:
                kernel._libs["probes"] = libs[src]
                for n, (tb, ks) in inputs.items():
                    ref = tb.index_select(0, ks[0].long())
                    sets = [(tb, k) for k in ks]
                    for name, mode, unroll, nbuf in gather_bench.VARIANTS:
                        def fn(t_, k_, m=mode, u=unroll, b=nbuf):
                            return probe_k.row_gather(t_, k_, m, u, b,
                                                      check_index=False)
                        equal = bool(torch.equal(fn(tb, ks[0]), ref))
                        line = dict(rep=rep, source=src, N=n, variant=name,
                                    equal=equal, ms=probe_k.time_graph(
                                        fn, sets, GRAPH_CALLS))
                        if shaped[src]:
                            out = (ctypes.c_int * 8)()
                            rc = libs[src].row_gather_shape(
                                n, 0 if mode == "direct" else 1, unroll,
                                nbuf, out)
                            if rc != 0:
                                raise RuntimeError(f"row_gather_shape: {rc}")
                            grid, block = out[0], out[1]
                            line.update(grid=grid, launch_floor_ms=(
                                probe_k.time_graph(
                                    lambda *_a, g=grid, b=block:
                                    probe_k.launch_floor(g, b, dev),
                                    sets, GRAPH_CALLS)))
                        emit(**line)
                        if not equal:
                            raise RuntimeError(f"{src} {name} N={n} differs "
                                               "from index_select")
    finally:
        if saved is None:
            kernel._libs.pop("probes", None)
        else:
            kernel._libs["probes"] = saved
    summary = {}
    for x in lines:
        key = (x["source"], x["N"], x["variant"])
        summary.setdefault(key, []).append(x["ms"])
    result = {"card": card, "lines": lines, "summary": [
        dict(source=s, N=n, variant=v, runs=len(ms), min_ms=min(ms),
             median_ms=statistics.median(ms))
        for (s, n, v), ms in summary.items()]}
    for x in result["summary"]:
        print(json.dumps({"summary": x}), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
