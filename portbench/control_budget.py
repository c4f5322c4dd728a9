"""A second control of the comparison that decides `correct`, for traffic
on which `control.py`'s narrower seed budget (`-k 1`) changes no record:
the plain reference, searched with a narrower whole budget (`-n`;
`--max-diff`, by default one lower than the configuration's), must come
out as not correct.

The configuration guarantees every alignment within its `-n`.  The search
keeps, past a read's best alignment, those with one difference more, so a
budget of `n` changes the record of a read whose best alignment has `n`
differences or more.  On low-error reads that is rare at one lower: the
control there is the nearest budget below that the traffic's reads reach
(`-n 1` for `lowerr`, whose reads carry an error or a private mutation
now and then, seldom two).  As in `control.py`, the control runs on the
reads that a run with the same seed would check (the sample of
`check_reads` drawn over `--calls` calls of the cell's pool) and counts
the reads whose `.aln` record differs from the reference's: the
`wrong_reads` a run would read.  `checks` and `correct` are the run's,
with `unanswered_reads` 0.

    python3 -m portbench.control_budget --workload <cell> --seeds 1 2 3 \
        [--calls 8] [--max-diff N]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def control_reading(workload: str, seed: int, n_calls: int,
                    root: str | None = None, workers: int = 8,
                    max_diff: int | None = None) -> dict:
    from portbench import cell as cell_mod
    from portbench import check, world as world_mod
    from portbench.gen import donor as gen_donor
    from portbench.gen import reads as gen_reads

    root = root or os.path.dirname(os.path.abspath(__file__))
    cell = cell_mod.load(workload, root)
    rpc = int(cell.config["reads_per_call"])
    world = world_mod.ensure(cell.config["world"],
                             os.path.join(root, ".cache"))
    haps = gen_donor.haplotypes(world, cell.traffic["donor"])
    pool = gen_reads.make_pool(haps, cell.traffic, seed, 1 + n_calls, rpc)
    pairs = check.sample(seed, n_calls, rpc, int(cell.config["check_reads"]))
    fq = [pool[1 + w, i].tobytes() for w, i in pairs]
    params = check.reference_params(cell.config)
    if max_diff is None:
        max_diff = int(params["max_diff"]) - 1
    t = time.perf_counter()
    ref = check.reference_records(world.bwt, params, fq, workers)
    t_ref = time.perf_counter() - t
    ctl = check.reference_records(world.bwt, dict(params, max_diff=max_diff),
                                  fq, workers)
    wrong = sum(a != b for a, b in zip(ref, ctl))
    checks = {"wrong_reads": {"value": wrong, "limit": 0},
              "unanswered_reads": {"value": 0, "limit": 0}}
    return {"workload": workload, "seed": seed, "checked_reads": len(fq),
            "max_diff": max_diff,
            "control_wrong_reads": wrong,
            "correct": all(v["value"] <= v["limit"]
                           for v in checks.values()),
            "checks": checks, "reference_s": t_ref}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--calls", type=int, default=8)
    ap.add_argument("--max-diff", type=int, default=None)
    args = ap.parse_args(argv)
    for seed in args.seeds:
        print(json.dumps(control_reading(
            args.workload, seed, args.calls,
            workers=min(8, os.cpu_count() or 1),
            max_diff=args.max_diff)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
