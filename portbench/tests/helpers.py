"""A checkout for the CPU tests: copies of the program, its native
sources and the benchmark in a temporary directory, with tiny test-only
worlds and cells in its BENCHMARK.json, and a driver that runs one whole
run there on `device="cpu"` in a fresh process."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

TINY_MG = {
    "name": "tiny_mg",
    "source": "test-only: a 120 kbp multi-genome",
    "world": {"kind": "multi_genome", "chrom": "21", "genome_bp": 120000,
              "genome_seed": 11, "repeat_frac": 0.15, "repeat_block": 500,
              "repeat_mut_rate": 0.05, "vcf_seed": 12, "snp_rate": 0.01,
              "indel_rate": 0.001, "comb_width": 124},
    "align": {"params": {"max_diff": 4, "is_multiref": True,
                         "n_threads": 2, "batch_size": 16},
              "engine": {"cap": 4096, "acap": 24, "kx": 2,
                         "max_iters": 50000},
              "index": {},
              "call": {"d_cap": 16, "queued": True, "qchunk": 2}},
    "reads_per_call": 48, "pool_reads_per_s": 200, "check_reads": 1000,
}
TINY_SINGLE = {
    "name": "tiny_single",
    "source": "test-only: a 60 kbp single genome",
    "world": {"kind": "single", "chrom": "chr1", "genome_bp": 60000,
              "genome_seed": 11, "repeat_frac": 0.0, "repeat_block": 500,
              "repeat_mut_rate": 0.05},
    "align": {"params": {"max_diff": 4, "is_multiref": False,
                         "n_threads": 2, "batch_size": 32},
              "engine": {"cap": 4096, "acap": 24, "kx": 2,
                         "max_iters": 50000},
              "index": {},
              "call": {"d_cap": 16, "queued": False}},
    "reads_per_call": 64, "pool_reads_per_s": 400, "check_reads": 1000,
}
CELLS = [("tiny_mg", "wgsim"), ("tiny_single", "wgsim")]


def make_checkout(dest: str) -> str:
    """A checkout at `dest` holding the program and the benchmark, with
    the tiny cells added as data; returns its path."""
    ignore = shutil.ignore_patterns(".cache", "__pycache__", "build")
    for d in ("bwbble_tpu_torch", "native", "portbench"):
        shutil.copytree(os.path.join(REPO, d), os.path.join(dest, d),
                        ignore=ignore)
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for cfg in (TINY_MG, TINY_SINGLE):
        with open(os.path.join(dest, "portbench", "configs",
                               cfg["name"] + ".json"), "w") as f:
            json.dump(cfg, f)
    for config, traffic in CELLS:
        bench["workloads"].append({
            "name": f"{config}.{traffic}", "config": config,
            "traffic": traffic, "chips": 1, "why": "test"})
    add_to_metric(bench, "reads_per_s", [f"{c}.{t}" for c, t in CELLS])
    with open(os.path.join(dest, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return dest


def add_to_metric(bench: dict, metric: str, workloads: list) -> None:
    """Lists `workloads` among the cells of the end-to-end `metric`."""
    m = next(m for m in bench["end_to_end"] if m["name"] == metric)
    m["workloads"] = m["workloads"] + workloads


DRIVER = """
import json, sys
from portbench import run
{patch}
out = run.run_cell({workload!r}, {seed}, {seconds}, {trace}, device="cpu")
print(json.dumps(out["info"]))
print(json.dumps(out["result"]))
print(json.dumps(run.forbidden_modules()))
"""


def run_cpu(checkout: str, workload: str, seed: int = 7,
            seconds: float = 0.5, trace: bool = False, patch: str = "",
            timeout: int = 600) -> tuple[dict, dict, list]:
    """One whole run on the CPU: (info, result, forbidden modules loaded)."""
    env = dict(os.environ, OMP_NUM_THREADS="2")
    env.pop("JAX_PLATFORMS", None)
    r = subprocess.run(
        [sys.executable, "-c", DRIVER.format(
            patch=patch, workload=workload, seed=seed, seconds=seconds,
            trace=trace)],
        cwd=checkout, capture_output=True, text=True, timeout=timeout,
        env=env)
    if r.returncode != 0:
        raise AssertionError(f"run failed ({r.returncode}):\n"
                             f"{r.stderr[-4000:]}")
    lines = r.stdout.strip().splitlines()
    return json.loads(lines[-3]), json.loads(lines[-2]), json.loads(lines[-1])
