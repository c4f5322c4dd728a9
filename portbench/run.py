"""One run of one cell of the port's benchmark.

    python3 -m portbench.run --workload <config>.<traffic> --seed N \
        --seconds S --trace 0|1

Set-up (`setup_s`, from the start of this process): the cell's files, its
world (built once into `portbench/.cache/`), the program's native library
(built once into `native/build/` where it is missing), the reads of every
call drawn from the seed as FASTQ bytes, the index loaded onto the card
through the program's own path, and one warm-up call at the cell's shapes.
The window then runs calls back to back until `--seconds` have passed;
each call does what `bwbble align` does after its index load: parse the
FASTQ bytes, `align_reads_device` with the configuration's settings, and
write the `.aln` (one file a call under TMPDIR, removed at the end).  After
the window, a sample of its reads is held against the plain reference
(`portbench/check.py`).  The last line of standard output is the result;
the numbers compared, each beside its limit, are the last lines of
standard error.  Without enough CUDA devices the run prints no result and
exits with 2; with JAX or the JAX package loaded, with 3.

The window is traced (`torch.profiler`, CUDA activity only) in a `--trace
1` run, and in a `--trace 0` run where one of the cell's end-to-end
metrics is read from the trace (`source: device_trace`).

The window runs with what set-up made frozen out of the collector's reach
(`gc.freeze()`): the imports' objects, the index and the pool live to the
end, and a full pass of the collector walks only what the window makes.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import traceback  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = ("jax", "jaxlib", "flax", "bwbble_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def log(msg: str) -> None:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)


def _power_limit() -> str | None:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return r.stdout.strip().splitlines()[0] if r.returncode == 0 and \
        r.stdout.strip() else None


def _native_library(checkout: str) -> float | None:
    """Build the program's native library where it is missing; the
    seconds it took, or None when it was there."""
    if os.path.exists(os.path.join(checkout, "native", "build",
                                   "libbwbble_native.so")):
        return None
    t = time.perf_counter()
    subprocess.run([sys.executable, "-m", "bwbble_tpu_torch.build_native"],
                   check=True, cwd=checkout, stdout=subprocess.DEVNULL)
    return time.perf_counter() - t


def _precalc(idx, params, world, dev, cold: dict):
    """The program's `-P` seed table, built by the program once into the
    world's directory and loaded from there."""
    from bwbble_tpu_torch.align.precalc import load_or_build_precalc
    path = os.path.join(world.path, "ref.k{}{}.pre".format(
        int(params.precalc_len), "" if params.is_multiref else ".S"))
    if os.path.exists(path):
        return load_or_build_precalc(idx, params, path, device=dev)
    t = time.perf_counter()
    tmp = path + ".building"
    if os.path.exists(tmp):
        os.remove(tmp)
    table = load_or_build_precalc(idx, params, tmp, device=dev)
    os.replace(tmp, path)
    cold["precalc_s"] = time.perf_counter() - t
    return table


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", root: str = HERE) -> dict:
    """Set up, run the window, check it; returns the result and the info
    the earlier output lines carry.  The program's settings are the
    configuration's `align` section: `params` (AlnParams), `engine`
    (EngineConfig), `index` (from_fmindex) and `call` (align_reads_device),
    with the `-P` seed table built where `params.use_precalc` is set; a
    cell on several chips runs on a mesh of them (dp = chips / tp, tp
    from `align.tp`, 1 where it is not given)."""
    from portbench import cell as cell_mod
    from portbench import check, world as world_mod
    from portbench.gen import donor as gen_donor
    from portbench.gen import reads as gen_reads
    from portbench.record import Call, Run
    from portbench.trace import Spans, device_events, profiler, reduce

    import torch

    from bwbble_tpu_torch.align.params import AlnParams
    from bwbble_tpu_torch.engine.device_index import from_fmindex
    from bwbble_tpu_torch.engine.inexact import EngineConfig
    from bwbble_tpu_torch.engine.pipeline import align_reads_device
    from bwbble_tpu_torch.formats.aln import write_aln_file
    from bwbble_tpu_torch.formats.fastq import parse_fastq_bytes
    from bwbble_tpu_torch.index.fmindex import FMIndex
    parts = {"imports_s": time.perf_counter() - T0}

    checkout = os.path.dirname(root)
    cache = os.path.join(root, ".cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    cell = cell_mod.load(workload, root)
    cfg_a = cell.config["align"]
    rpc = int(cell.config["reads_per_call"])
    info: dict = {"portbench": "info", "cell": workload, "seed": seed}
    cold: dict = {}

    world = world_mod.ensure(cell.config["world"], cache, log)
    if world.built_s:
        cold["world"] = world.built_s
    t = time.perf_counter()
    haps = gen_donor.haplotypes(world, cell.traffic["donor"])
    parts["donor_s"] = time.perf_counter() - t
    t = _native_library(checkout)
    if t is not None:
        cold["native_build_s"] = t

    devices = ([torch.device("cuda", i) for i in range(cell.chips)]
               if device == "cuda" else [torch.device(device)] * cell.chips)
    dev = devices[0]
    mesh = None
    if cell.chips > 1:
        from bwbble_tpu_torch.parallel.shard import make_mesh
        tp = int(cfg_a.get("tp", 1))
        mesh = make_mesh(cell.chips // tp, tp, devices)

    t = time.perf_counter()
    n_pool = 1 + max(1, math.ceil(seconds * float(
        cell.config["pool_reads_per_s"]) / rpc))
    pool = gen_reads.make_pool(haps, cell.traffic, seed, n_pool, rpc)
    rec_len = pool.shape[2]
    call_bytes = [pool[k].tobytes() for k in range(n_pool)]
    del pool, haps
    parts["reads_s"] = time.perf_counter() - t

    params = AlnParams(**cfg_a["params"])
    ecfg = EngineConfig(**cfg_a["engine"])
    t = time.perf_counter()
    idx = FMIndex.load(world.bwt, load_sa=False)
    didx = from_fmindex(idx, device=dev, **cfg_a["index"])
    precalc = (_precalc(idx, params, world, dev, cold)
               if params.use_precalc else None)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    parts["index_s"] = time.perf_counter() - t - cold.get("precalc_s", 0.0)

    tmp = tempfile.mkdtemp(prefix="portbench-")
    traced = trace or any(m["source"] == "device_trace"
                          for m in cell.end_to_end)
    span = Spans(traced)
    gc_s = [0.0, 0.0]                   # the collector's seconds; its start

    def gc_clock(phase, _info):
        if phase == "start":
            gc_s[1] = time.perf_counter()
        else:
            gc_s[0] += time.perf_counter() - gc_s[1]

    def one_call(k: int, path: str) -> Call:
        c = Call(reads=rpc)
        cpu0, gc0 = time.process_time(), gc_s[0]
        try:
            with span("parse"):
                t0 = time.perf_counter()
                reads = parse_fastq_bytes(call_bytes[k])
                c.parse_s = time.perf_counter() - t0
            with span("align"):
                t0 = time.perf_counter()
                alns = align_reads_device(
                    idx, didx, reads, params, ecfg, stats=c.stats,
                    precalc=precalc, mesh=mesh, device=dev, **cfg_a["call"])
                c.align_s = time.perf_counter() - t0
            with span("write"):
                t0 = time.perf_counter()
                write_aln_file(path, alns)
                c.write_s = time.perf_counter() - t0
            if len(alns) != reads.count or reads.count != rpc:
                raise RuntimeError(f"{len(alns)} records for {reads.count} "
                                   f"reads of {rpc}")
            c.aln_path, c.ok = path, True
        except Exception:                    # counted as failed, and shown
            traceback.print_exc(file=sys.stderr)
        c.cpu_s = time.process_time() - cpu0
        c.gc_s = gc_s[0] - gc0
        return c

    def sync():
        for d in {d for d in devices if d.type == "cuda"}:
            torch.cuda.synchronize(d)

    gc.callbacks.append(gc_clock)
    try:
        t = time.perf_counter()
        warm = one_call(0, os.path.join(tmp, "warmup.aln"))
        if not warm.ok:
            raise RuntimeError("the warm-up call failed")
        sync()
        # what set-up made lives to the end: the collector's full passes
        # in the window walk only what the window makes
        gc.collect()
        gc.freeze()
        parts["warmup_s"] = time.perf_counter() - t
        setup_s = time.perf_counter() - T0

        # the trace of the cards: CUDA runs only (the CPU has none to trace)
        prof = profiler() if traced and dev.type == "cuda" else None
        if prof is not None:
            t = time.perf_counter()
            prof.__enter__()
            info["trace_start_s"] = time.perf_counter() - t
        calls: list = []
        reused = 0
        gc_s[0] = 0.0
        cpu0 = time.process_time()
        try:
            with span("window"):
                tw = time.perf_counter()
                while True:
                    k = len(calls)
                    if k >= n_pool - 1:
                        reused += rpc
                    calls.append(one_call(1 + k % (n_pool - 1), os.path.join(
                        tmp, f"call{k}.aln")))
                    if time.perf_counter() - tw >= seconds:
                        break
                window_s = time.perf_counter() - tw
            info["window_cpu_s"] = time.process_time() - cpu0
            info["window_gc_s"] = gc_s[0]
        finally:
            if prof is not None:
                t = time.perf_counter()
                prof.__exit__(None, None, None)
                info["trace_stop_s"] = time.perf_counter() - t
        run = Run(cell=workload, config=cell.config, traffic=cell.traffic,
                  calls=calls, window_s=window_s, setup_s=setup_s,
                  device=dev.type)
        if prof is not None:
            t = time.perf_counter()
            run.trace = reduce(device_events(prof), span.spans,
                               len(set(devices)))
            del prof
            info["trace_reduce_s"] = time.perf_counter() - t
        peak = max((torch.cuda.max_memory_allocated(d) for d in set(devices)
                    if d.type == "cuda"), default=0)

        # the program's state goes before the reference runs
        del didx, idx, precalc, mesh
        gc.unfreeze()
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()

        t = time.perf_counter()
        pairs = check.sample(seed, len(calls), rpc,
                             int(cell.config["check_reads"]))
        pairs = [(w, i) for w, i in pairs if calls[w].ok]
        mine: dict = {}
        for w in sorted({w for w, _ in pairs}):
            mine[w] = check.program_records(calls[w].aln_path, rpc)
        fq = [call_bytes[1 + w % (n_pool - 1)][i * rec_len:(i + 1) * rec_len]
              for w, i in pairs]
        ref = check.reference_records(world.bwt, check.reference_params(
            cell.config), fq, workers=min(8, os.cpu_count() or 1))
        wrong = sum(1 for (w, i), r in zip(pairs, ref) if mine[w][i] != r)
        info["reference_s"] = time.perf_counter() - t
        info["checked_reads"] = len(pairs)

        # the readers may read the window's `.aln` files: before they go
        metrics = {}
        for m in (cell.per_layer if trace else cell.end_to_end):
            value = cell_mod.metric_reader(m["name"], root).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    finally:
        if gc_clock in gc.callbacks:
            gc.callbacks.remove(gc_clock)
        shutil.rmtree(tmp, ignore_errors=True)

    failed = sum(c.reads for c in calls if not c.ok)
    checks = {"wrong_reads": {"value": wrong, "limit": 0},
              "unanswered_reads": {"value": failed, "limit": 0}}
    correct = bool(calls) and all(v["value"] <= v["limit"]
                                  for v in checks.values())

    devinfo = {"platform": "gpu" if dev.type == "cuda" else dev.type,
               "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                        else dev.type),
               "count": len(devices), "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": run.reads, "failed": failed,
              "metrics": metrics, "device": devinfo}
    if trace and run.trace is not None:
        devinfo["busy_s"] = run.trace.busy_s
        devinfo["window_s"] = run.trace.window_s
        result["breakdown"] = {"device_ops": run.trace.device_ops,
                               "idle_gaps": run.trace.idle_gaps}
    result["checks"] = checks

    info.update(calls=len(calls), reads=run.reads, reads_reused=reused,
                window_s=window_s, setup_s=setup_s, setup_parts=parts,
                cold_setup=cold, torch_threads=torch.get_num_threads(),
                host_cores=os.cpu_count(), loadavg=os.getloadavg(),
                peak_device_gb=peak / 1e9,
                card=_power_limit() if dev.type == "cuda" else None,
                calls_failed=sum(1 for c in calls if not c.ok),
                call_seconds=[c.parse_s + c.align_s + c.write_s
                              for c in calls],
                call_cpu_s=[c.cpu_s for c in calls],
                call_gc_s=[c.gc_s for c in calls],
                call_stats={k: [c.stats.get(k) for c in calls]
                            for k in ("t_dbounds", "t_search", "t_host")})
    return {"result": result, "info": info}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench import cell as cell_mod
    chips = cell_mod.load(args.workload).chips
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"this cell needs {chips} CUDA device(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
            " found")
        return 2
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        log(f"JAX or the JAX package was loaded: {', '.join(bad)}")
        return 3
    print(json.dumps(out["info"]), flush=True)
    for name, c in out["result"]["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr, flush=True)
    print(json.dumps(out["result"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
