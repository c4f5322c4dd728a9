"""Where the plain search's time goes, on the CPU.

    python -m bwbble_tpu_torch.benchmarks.plain_cost [B ...]

Runs the plain fixed-batch search (engine/inexact.py:fixed_search_plain) on
the mixed test world's reads, repeated to B lanes (default 48 and 256), with
lists of 128 intervals, and prints for each B: the lockstep iterations (the
longest read's work units), the aten operations and host synchronisations
(`nonzero`, and `_local_scalar_dense` from `int()`/`bool()` of a tensor)
dispatched a iteration, and the milliseconds a iteration on this host's CPU
with one thread, twice: as the plain version runs, and with its exact-
completion step given every list column (dead ones included) as it was
before the step took only the columns that hold live intervals.  Both give
the same results; the script checks that.  The counts do not depend on the
host; the times are this CPU's.
"""

from __future__ import annotations

import collections
import sys
import time

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from bwbble_tpu_torch import worlds
from bwbble_tpu_torch.align.params import AlnParams
from bwbble_tpu_torch.engine import inexact
from bwbble_tpu_torch.engine.device_index import from_fmindex
from bwbble_tpu_torch.gold.engine import calculate_d


class _Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[str(func.overloadpacket)] += 1
        return func(*args, **(kwargs or {}))


def _full_width(expand_step):
    """expand_step given the lists padded back to their capacity with dead
    columns (L 0, U -1): the step's cost before it took live columns only."""
    def step(didx, Ls, Us, cnt, c, cap=None):
        if cap is not None and Ls.shape[1] < cap:
            pad = cap - Ls.shape[1]
            Ls = torch.nn.functional.pad(Ls, (0, pad), value=0)
            Us = torch.nn.functional.pad(Us, (0, pad), value=-1)
        return expand_step(didx, Ls, Us, cnt, c, cap)
    return step


def main(argv: list[str]) -> list[dict]:
    torch.set_num_threads(1)
    lanes = [int(a) for a in argv] or [48, 256]
    idx, rd = worlds.mixed_world()
    didx = from_fmindex(idx, device="cpu")
    p = AlnParams(max_diff=3, batch_size=128)
    sl = int(p.seed_length)
    D = np.zeros((rd.count, rd.max_len + 1, 2), dtype=np.int32)
    Ds = np.zeros((rd.count, sl + 1, 2), dtype=np.int32)
    for r in range(rd.count):
        n = int(rd.lengths[r])
        D[r, :n + 1] = calculate_d(idx, rd.seq[r], n, p)
        if n > sl:
            Ds[r] = calculate_d(idx, rd.seq[r], sl, p)
    cfg = inexact.EngineConfig(cap=4096, acap=24, kx=2, max_iters=20_000,
                               xcap=128)
    rows = []
    for B in lanes:
        sel = np.resize(np.arange(rd.count), B)
        a = [torch.from_numpy(np.ascontiguousarray(x)) for x in (
            np.asarray(rd.rc, dtype=np.int8)[sel],
            rd.lengths[sel].astype(np.int32), D[sel], Ds[sel])]
        with _Count() as cnt:
            res = inexact.fixed_search_plain(didx, *a, p, cfg)
        iters = int(res["n_work"].max())
        t = time.time()
        inexact.fixed_search_plain(didx, *a, p, cfg)
        live_ms = (time.time() - t) * 1e3
        step = inexact.expand_step
        inexact.expand_step = _full_width(step)
        try:
            t = time.time()
            full = inexact.fixed_search_plain(didx, *a, p, cfg)
            full_ms = (time.time() - t) * 1e3
        finally:
            inexact.expand_step = step
        same = all(torch.equal(res[k], full[k]) for k in res)
        ops = sum(cnt.ops.values())
        row = dict(
            lanes=B, iterations=iters, ops_per_iter=ops / iters,
            syncs_per_iter=(cnt.ops["aten.nonzero"]
                            + cnt.ops["aten._local_scalar_dense"]) / iters,
            nonzero=cnt.ops["aten.nonzero"],
            scalar_reads=cnt.ops["aten._local_scalar_dense"],
            cpu_ms_per_iter=live_ms / iters,
            cpu_ms_per_iter_full_width=full_ms / iters, same_results=same)
        rows.append(row)
        print(row, flush=True)
    return rows


if __name__ == "__main__":
    main(sys.argv[1:])
