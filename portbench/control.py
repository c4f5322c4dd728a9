"""The control of the comparison that decides `correct`: the plain
reference, put in the program's place with one guarantee of the
configuration broken, must come out as not correct.

The configuration states the search budget of bwbble's reference aligner
(`-n`, with the seed's budget `-k 2`); the control searches with the
seed's budget one lower (`-k 1`), the narrower and faster search a later
change could be tempted by.  It runs on the reads that a run with the
same seed would check (the sample of `check_reads` drawn over `--calls`
calls of the cell's pool) and counts the reads whose `.aln` record
differs from the reference's: the `wrong_reads` a run would read.

    python3 -m portbench.control --workload <cell> --seeds 1 2 3 [--calls 8]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def control_reading(workload: str, seed: int, n_calls: int,
                    root: str | None = None, workers: int = 8) -> dict:
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
    t = time.perf_counter()
    ref = check.reference_records(world.bwt, check.reference_params(
        cell.config), fq, workers)
    t_ref = time.perf_counter() - t
    ctl = check.reference_records(world.bwt, check.reference_params(
        cell.config, max_diff_seed=1), fq, workers)
    return {"workload": workload, "seed": seed, "checked_reads": len(fq),
            "control_wrong_reads": sum(a != b for a, b in zip(ref, ctl)),
            "reference_s": t_ref}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--calls", type=int, default=8)
    args = ap.parse_args(argv)
    for seed in args.seeds:
        print(json.dumps(control_reading(args.workload, seed, args.calls,
                                         workers=min(8, os.cpu_count()
                                                     or 1))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
