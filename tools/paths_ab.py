"""Time the easy, single and `-P` paths of two source trees against each
other, on one card, in one call.

    python3 tools/paths_ab.py OTHER_ROOT [--order OTTO] [--workdir DIR]

Each run is a process of its own that imports `bwbble_tpu_torch` from one
tree (O: the tree at OTHER_ROOT, T: this one) and builds that tree's
kernels and native library.  The runs go in the order given, all on the
same easy world (`worlds.easy_world`, as chip_smoke.py makes it, indexed
once), and each times what chip_smoke.py times there:
  - `easy`: a warm-up on 256 reads, then the 16 384 reads in fixed batches
    of 8 192 (`d_cap` 16);
  - `single_cli`: `align -n 4 -S --batch 8192` through `cli.main` in the
    process;
  - `single`: the same reads with `-S`, in-process;
  - `single_queued`: the same at 512 lanes in the ring queue;
  - `pre`: chip_smoke.py's pre_path, `-P` from the k = 12 seed table
    (built on the card by the first run into the work directory as
    `<fasta>.pre`, read back by the later ones), a warm-up on 256 reads,
    then the 16 384 reads in fixed batches of 8 192;
  - `pre_queued`: the same at 512 lanes in the ring queue.
Each run prints one JSON line a timed call: seconds, reads/s, `t_dbounds`,
`t_search`, `t_host`, the tiers, the gold pool's kind, workers and start
seconds (where the tree reports them), and where the host time goes: the
process's CPU seconds, the seconds in the search calls (`inexact_search`,
`inexact_search_queued`), in `_assemble` and in Python's garbage
collector, and the host's load average.  Every run's `.aln` files must be
byte-equal to the first run's.  Fails on a card-less machine.
"""

from __future__ import annotations

import argparse
import dataclasses
import filecmp
import gc
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CALLS = ("easy", "single", "single_queued", "pre", "pre_queued")


def _timed(fn, acc: dict, key: str):
    def wrapped(*a, **kw):
        t0 = time.time()
        try:
            return fn(*a, **kw)
        finally:
            acc[key] = acc.get(key, 0.0) + time.time() - t0
    return wrapped


def run_one(root: str, workdir: str, tag: str) -> None:
    """One tree's timed calls, in this process."""
    sys.path.insert(0, root)
    import torch
    from bwbble_tpu_torch import build_native, cli, worlds
    from bwbble_tpu_torch.align.params import AlnParams
    from bwbble_tpu_torch.align.precalc import load_or_build_precalc
    from bwbble_tpu_torch.engine import pipeline
    from bwbble_tpu_torch.engine.device_index import from_fmindex
    from bwbble_tpu_torch.engine.inexact import EngineConfig
    from bwbble_tpu_torch.formats.aln import write_aln_file
    from bwbble_tpu_torch.formats.fastq import read_fastq
    from bwbble_tpu_torch.index.fmindex import FMIndex

    if not torch.cuda.is_available():
        raise RuntimeError("paths_ab runs on a CUDA device only")
    dev = torch.device("cuda")
    build_native.build(verbose=False)
    threads = max(1, min(8, os.cpu_count() or 1))
    efa, efq = worlds.easy_world(workdir, num_reads=16_384)
    if not os.path.exists(efa + ".bwt") and cli.main(["index", efa]) != 0:
        raise RuntimeError("index failed")
    eidx = FMIndex.load(efa + ".bwt", load_sa=False)
    ereads = read_fastq(efq)
    edidx = from_fmindex(eidx, device=dev)
    p_easy = AlnParams(max_diff=4, batch_size=8192, n_threads=threads)
    p_single = dataclasses.replace(p_easy, is_multiref=False)
    p_pre = dataclasses.replace(p_easy, use_precalc=True)
    cfg = EngineConfig(cap=32768, acap=24, kx=2, max_iters=500_000)

    acc: dict = {}
    for name in ("inexact_search", "inexact_search_queued", "_assemble"):
        setattr(pipeline, name, _timed(getattr(pipeline, name), acc, name))

    def gc_clock(phase, _info, t=[0.0]):
        if phase == "start":
            t[0] = time.time()
        else:
            acc["gc"] = acc.get("gc", 0.0) + time.time() - t[0]
    gc.callbacks.append(gc_clock)

    def timed(call, fn):
        acc.clear()
        st: dict = {}
        objects = len(gc.get_objects())
        load = os.getloadavg()[0]
        torch.cuda.synchronize()
        c0, t0 = time.process_time(), time.time()
        out = fn(st)
        torch.cuda.synchronize()
        dt, cpu = time.time() - t0, time.process_time() - c0
        line = dict(run=tag, call=call, seconds=dt,
                    reads_per_sec=ereads.count / dt, cpu_seconds=cpu,
                    search_call_seconds=acc.get("inexact_search", 0.0)
                    + acc.get("inexact_search_queued", 0.0),
                    assemble_seconds=acc.get("_assemble", 0.0),
                    gc_seconds=acc.get("gc", 0.0), gc_objects=objects,
                    loadavg_1min=load,
                    **{k: st.get(k) for k in ("t_dbounds", "t_search",
                                              "t_host", "tiers",
                                              "fallback_reads", "prerouted",
                                              "gold_pool", "gold_workers",
                                              "gold_pool_start_s",
                                              "gold_pool_shared_bytes")})
        print(json.dumps(line), flush=True)
        return out

    def align(params, reads=ereads, **kw):
        return lambda st: pipeline.align_reads_device(
            eidx, edidx, reads, params, cfg, d_cap=16, stats=st, device=dev,
            **kw)

    align(p_easy, worlds.head_reads(ereads, 256))({})          # warm-up
    out = {"easy": timed("easy", align(p_easy, queued=False))}
    timed("single_cli", lambda st: cli.main(
        ["align", "-n", "4", "-S", "-t", str(threads), "--batch", "8192",
         efa, efq, os.path.join(workdir, f"{tag}_single_cli.aln")]))
    out["single"] = timed("single", align(p_single, queued=False))
    out["single_queued"] = timed("single_queued", align(
        dataclasses.replace(p_single, batch_size=512), queued=True))
    table = load_or_build_precalc(eidx, p_pre, efa + ".pre", device=dev)
    align(p_pre, worlds.head_reads(ereads, 256), precalc=table)({})
    out["pre"] = timed("pre", align(p_pre, queued=False, precalc=table))
    out["pre_queued"] = timed("pre_queued", align(
        dataclasses.replace(p_pre, batch_size=512), queued=True,
        precalc=table))
    for call, alns in out.items():
        write_aln_file(os.path.join(workdir, f"{tag}_{call}.aln"), alns)


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("other_root")
    ap.add_argument("--order", default="OTTO")
    ap.add_argument("--workdir", default=os.path.join(HERE, ".bench_torch",
                                                      "paths_ab"))
    ap.add_argument("--one", help=argparse.SUPPRESS)
    ap.add_argument("--tag", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.one:
        run_one(args.one, args.workdir, args.tag)
        return 0
    roots = {"O": os.path.abspath(args.other_root), "T": HERE}
    os.makedirs(args.workdir, exist_ok=True)
    tags = []
    for i, which in enumerate(args.order):
        tag = f"{i}{which}"
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            args.other_root, "--one", roots[which],
                            "--workdir", args.workdir, "--tag", tag],
                           cwd=roots[which])
        if r.returncode != 0:
            print(f"paths_ab: run {tag} failed", file=sys.stderr)
            return 1
        tags.append(tag)
    same = all(filecmp.cmp(
        os.path.join(args.workdir, f"{tags[0]}_{c}.aln"),
        os.path.join(args.workdir, f"{t}_{c}.aln"), shallow=False)
        for t in tags[1:] for c in CALLS + ("single_cli",))
    print(json.dumps({"runs": tags, "aln_equal": same}), flush=True)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
