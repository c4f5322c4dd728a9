"""Where the search kernel's cycles go, phase by phase, on the card.

    python3 tools/kernel_phases.py [--world main|easy|both]
        [--genome-bp N] [--workdir DIR] [--reads N]

Builds a trace copy of csrc/ring_search.cu with clock64() probes at the
phase boundaries of a pop (the library the port loads has none) and runs
it through the search wrappers.  World `main`: the first N (768) reads of
the main-path world (`worlds.chr21_world`, as chip_smoke.py builds it; D
bounds from the native scan) at comparison A's ring settings (512 lanes)
and tier 1's fixed settings.  World `easy`: comparison (c)'s seeded inputs
(the easy world's first 8 192 reads, seeded from the k = 12 table, 32
slots; kernel_ab.easy_world_inputs) as one fixed batch of 8 192 lanes and
one ring launch of 512 lanes over the first 1 024 reads.  For each run it
prints the launch's time (the events its C launch records), the cycles
that thread 0 of every lane spent in each phase, summed
over the lanes and divided by their pops, and the same cycles outside the
pops (stage and walk) divided by the reads; the counts of pops served from
registers and from the arena; the longest and the mean lane's wall time
(`%globaltimer`, a lane's first probe to its last) beside the launch's; and
the lanes an SM holds at once (`kernel.resident_lanes`), the SM count and
the waves of lanes the launch needs.  Phases:
stage (a read's start), scan (loop checks, lowest bucket), fetch (the node,
the expansion rows asked for, the head update), prune, emit, exact (a
whole exact completion), allow (D reads and the allow decisions, while the
rows are in flight), rank (counting the rows: waits for them), slots, link
(push, heads, frame row), walk (paths and per-read outputs).  The probes
cost cycles of their own (a clock read and an add each); compare phases
within a run.  The anchors below are lines of the kernel's source: an
edit of one of them is an edit of this file too
(tests/test_torch_kernel_tools.py checks that each is found once).  Fails
on a card-less machine.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from bwbble_tpu_torch.engine import kernel
from kernel_ab import easy_world_inputs, kernel_ms, main_world_inputs
from bwbble_tpu_torch.engine.inexact import EngineConfig, ring_statics

PHASES = ("stage", "scan", "fetch", "prune", "emit", "exact", "allow",
          "rank", "slots", "link", "walk")
COUNTS = ("from_regs", "from_arena", "expansions", "emits", "exacts")
NPH = 18        # 11 phases, 5 counts, the longest and the summed lane span

_DECL = """
#define NPH 18
__device__ unsigned long long rs_ph[NPH];
__device__ __forceinline__ long long ph_ns() {
    long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    return t;
}
extern "C" int ring_search_phase_clocks(unsigned long long* out) {
    return (int)cudaMemcpyFromSymbol(out, rs_ph, sizeof(rs_ph));
}
extern "C" int ring_search_phase_reset() {
    unsigned long long z[NPH] = {0};
    return (int)cudaMemcpyToSymbol(rs_ph, z, sizeof(z));
}
#define PH(k) do { long long _n = clock64(); ph[k] += _n - ph_last; \\
                   ph_last = _n; } while (0)
#define CNT(k) (ph[k]++)
"""

# (anchor, text, put the text after the anchor); each anchor must occur once
_PROBES = (
    ("#define OV_WORK 16\n", _DECL, True),
    ("    const int lane = blockIdx.x;\n",
     "    long long ph[NPH];\n    for (int k = 0; k < NPH; k++) ph[k] = 0;\n"
     "    long long ph_last = clock64();\n"
     "    const long long ph_t0 = ph_ns();\n", True),
    ("                head[b] = b == 0 ? n_open - 1 : -1;\n"
     "        __syncwarp();\n", "        PH(0);\n", True),
    ("            if (node < 0) break;\n", "            PH(1);\n", True),
    ("                if (f == regf) {\n", "                    CNT(11);\n",
     True),
    ("                } else {\n                    const int32_t* sp = A + "
     "(size_t)f * ROWW + NW * s;\n", "                    CNT(12);\n", True),
    ("            n_open--;\n            work++;\n", "            PH(2);\n",
     False),
    ("            if (cont) continue;\n", "            PH(3);\n", False),
    ("                                           });\n"
     "                if (fin) break;\n                continue;\n",
     "                PH(4); CNT(14);\n", False),
    ("                if (over) { S.overflow |= over; break; }\n",
     "                PH(5); CNT(15);\n", False),
    ("            const IT rk = count_row<MULTI>(row, carr, half ? 0 : 1, "
     "jc);\n", "            PH(6);\n", False),
    ("            const IT rk = count_row<MULTI>(row, carr, half ? 0 : 1, "
     "jc);\n", "            asm volatile(\"\" :: \"l\"((long long)rk));\n"
     "            PH(7);\n", True),
    ("            const int b = sc < 0 ? 0 : (sc > NB - 1 ? NB - 1 : sc);\n",
     "            asm volatile(\"\" :: \"r\"(b));\n            PH(8);\n", True),
    ("                rL = sL; rU = sU; rm1 = sm1; rm2 = sm2;\n            }\n"
     "            __syncwarp();\n", "            PH(9); CNT(13);\n", True),
    ("        if (FIXED) break;\n", "        PH(10);\n", False),
    ("        rid = __shfl_sync(RS_FULL, nrid, 0);\n    }\n}\n",
     "        rid = __shfl_sync(RS_FULL, nrid, 0);\n    }\n    if (t == 0) {\n"
     "        for (int k = 0; k < 16; k++)\n"
     "            atomicAdd(&rs_ph[k], (unsigned long long)ph[k]);\n"
     "        const unsigned long long span = ph_ns() - ph_t0;\n"
     "        atomicMax(&rs_ph[16], span);\n"
     "        atomicAdd(&rs_ph[17], span);\n    }\n}\n",
     None),
)


def trace_source(src: str) -> str:
    """The kernel's source with the probes inserted."""
    for anchor, text, after in _PROBES:
        if src.count(anchor) != 1:
            raise RuntimeError(f"probe anchor not found once: {anchor!r}")
        new = text if after is None else (
            anchor + text if after else text + anchor)
        src = src.replace(anchor, new)
    return src


def build_trace() -> ctypes.CDLL:
    """Compile the trace copy (nvcc, as engine/kernel.py:build does) into
    build/ and load it, bound as the search library."""
    with open(os.path.join(kernel.CSRC, "ring_search.cu")) as f:
        src = trace_source(f.read())
    digest = hashlib.sha256(src.encode()).hexdigest()[:16]
    os.makedirs(kernel.BUILD_DIR, exist_ok=True)
    cu = os.path.join(kernel.BUILD_DIR, f"ring_search_phases_{digest}.cu")
    so = cu[:-3] + ".so"
    with open(cu, "w") as f:
        f.write(src)
    r = subprocess.run([kernel._nvcc(), "-gencode",
                        "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                        "--expt-relaxed-constexpr", "-shared", "-Xcompiler",
                        "-fPIC", "-o", so, cu], capture_output=True,
                       text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{r.stderr[-3000:]}")
    lib = ctypes.CDLL(so)
    kernel._bind_ring_search(lib)
    lib.ring_search_phase_clocks.argtypes = [ctypes.c_void_p]
    return lib


def main(argv: list[str]) -> list[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--world", choices=("main", "easy", "both"),
                    default="both")
    ap.add_argument("--genome-bp", type=int, default=46_700_000)
    ap.add_argument("--workdir", default=os.path.join(
        os.path.dirname(kernel.BUILD_DIR), ".bench_torch"))
    ap.add_argument("--reads", type=int, default=768)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("kernel_phases runs on a CUDA device only")
    lib = build_trace()
    dev = torch.device("cuda")
    # (name, index, params, cfg, inputs, seeds, lanes or None: fixed)
    runs = []
    if args.world in ("main", "both"):
        didx, params, a = main_world_inputs(args.genome_bp, args.workdir,
                                            args.reads, dev)
        ring = EngineConfig(cap=65536, acap=24, kx=2, max_iters=500_000,
                            xcap=128)
        tier1 = EngineConfig(cap=32768, xcap=128)
        runs += [
            ("ring, 512 lanes", didx, params, ring, a, None, 512),
            ("fixed, tier 1", didx, params, tier1, a, None, None)]
    if args.world in ("easy", "both"):
        edidx, p_pre, e, sd = easy_world_inputs(args.workdir, 8192, dev,
                                                seeded=True)
        cfg_pc = EngineConfig(cap=32768, acap=24, kx=2, max_iters=500_000,
                              xcap=128)
        runs += [
            ("seeded fixed, 8192 lanes (c)", edidx, p_pre, cfg_pc, e, sd,
             None),
            ("seeded ring, 512 lanes, 1024 reads", edidx, p_pre, cfg_pc,
             [x[:1024] for x in e], tuple(x[:1024] for x in sd), 512)]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    # the lanes an SM holds of the library the port loads (not the trace's)
    per_sm = {}
    for name, _di, prm, cfg, a, sd, lanes in runs:
        S = ring_statics(prm, cfg, a[0].shape[1], a[3].shape[1],
                         fixed=lanes is None,
                         seed_slots=0 if sd is None else sd[0].shape[1])
        per_sm[name] = kernel.resident_lanes(S)
    saved = kernel._libs.get("ring_search")
    kernel._libs["ring_search"] = lib
    out = []
    try:
        for name, di, prm, cfg, a, sd, lanes in runs:
            def fn(tm):
                if lanes is None:
                    return kernel.fixed_search(di, *a, prm, cfg, sd, tm)
                return kernel.ring_search(di, *a, prm, cfg, lanes, sd, tm)
            fn(None)
            torch.cuda.synchronize()
            lib.ring_search_phase_reset()
            got, ms = kernel_ms(fn)
            buf = np.zeros(NPH, dtype=np.uint64)
            lib.ring_search_phase_clocks(buf.ctypes.data)
            pops = int(got["pops"].sum())
            n = a[0].shape[0]
            used = n if lanes is None else min(lanes, n)
            cyc = buf[:len(PHASES)].astype(np.float64)
            ph = dict(zip(PHASES, cyc))
            row = dict(run=name, reads=n, lanes=used, ms=ms,
                       pops=pops, work=int(got["n_work"].sum()),
                       cycles_per_pop=float(cyc.sum() / pops),
                       phases={p: float(c / pops) for p, c in ph.items()},
                       outside_pops_cycles_per_read=float(
                           (ph["stage"] + ph["walk"]) / n),
                       outside_pops_share=float(
                           (ph["stage"] + ph["walk"]) / cyc.sum()),
                       cycles_per_read=float(cyc.sum() / n),
                       counts={c: int(v) for c, v in zip(
                           COUNTS, buf[len(PHASES):16])},
                       lane_span_max_ms=float(buf[16]) / 1e6,
                       lane_span_mean_ms=float(buf[17]) / 1e6 / used,
                       resident_lanes_per_sm=per_sm[name], sms=sms,
                       waves=-(-used // (per_sm[name] * sms)),
                       card=torch.cuda.get_device_name(0))
            out.append(row)
            print(json.dumps(row), flush=True)
    finally:
        if saved is None:
            kernel._libs.pop("ring_search", None)
        else:
            kernel._libs["ring_search"] = saved
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
