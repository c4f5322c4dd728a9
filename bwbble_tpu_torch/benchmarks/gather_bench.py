"""Head-to-head benchmark of row-gather strategies for the rank table.

    python -m bwbble_tpu_torch.benchmarks.gather_bench

Counterpart of benchmarks/gather_bench.py (its Pallas gathers gather_vmem
and gather_hbm are the TPU kernel K6; here `kernels.row_gather`,
csrc/probes.cu).  The whole aligner reduces to fetching random 128-byte rows
of the fused rank table; this times that fetch alone: out[i] = table[idx[i]]
on a [78 125, 32] int32 table (10 MB: the easy world's 10 Mbp fwd+RC / 128)
at N = 16 384 and 65 536 indices.

Variants:
  take       torch.index_select (PyTorch's own gather, the yardstick)
  direct u1  8 threads a row, 8 x 16-byte loads, in a persistent grid; a
             warp moves 4 rows a step (u8: 32, 8 rows a group of 8
             threads).  The table fits the card's 50 MB L2, which plays
             the part VMEM plays for the TPU variant `vmem`
  ring b8    a ring of 8 row slots in shared memory a warp, one bulk copy
             (cp.async.bulk, an mbarrier a slot) a row, the landed rows
             leaving by bulk stores of contiguous output rows (the TPU's
             `hbm` ring of row DMAs); b32: 32 slots
Each is checked equal to `take` ("OK" / "WRONG").  Table and indices are
random, made on the card from a seed; timed with CUDA events over 10 calls
on 4 index sets after a warm-up on a fifth.  With device="cpu" (the tests)
the plain version runs and nothing is timed.
"""

from __future__ import annotations

import sys

import torch

from bwbble_tpu_torch.benchmarks.kernels import (GATHER_WORDS, row_gather,
                                                 time_calls)
from bwbble_tpu_torch.engine import resolve_device

NBLK = 78_125        # 10 Mbp fwd+RC / 128
NS = (16_384, 65_536)
REPS = 10
VARIANTS = (("direct u1", "direct", 1, 8), ("direct u8", "direct", 8, 8),
            ("ring b8", "ring", 1, 8), ("ring b32", "ring", 1, 32))


def make_inputs(nblk: int, n: int, device, seed: int = 0, sets: int = 5):
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    table = torch.randint(-2**31, 2**31 - 1, (nblk, GATHER_WORDS),
                          generator=g, device=device, dtype=torch.int32)
    ks = [torch.randint(0, nblk, (n,), generator=g, device=device,
                        dtype=torch.int32) for _ in range(sets)]
    return table, ks


def run(device=None, nblk: int = NBLK, ns=NS, seed: int = 0) -> list[dict]:
    """Every variant at every N: its `equal` check against index_select
    and, on the card, ms a call and ns a row (`take` is the library
    call)."""
    dev = resolve_device(device)
    out = []
    for n in ns:
        table, ks = make_inputs(nblk, n, dev, seed)
        print(f"-- table [{nblk}, 32] int32 ({nblk * 128 / 1e6:.0f} MB), "
              f"N={n}", flush=True)
        ref = table.index_select(0, ks[0].to(torch.int64))
        rows = [dict(variant="take", N=n, equal=True,
                     fn=lambda k: table.index_select(0, k.to(torch.int64)))]
        for name, mode, unroll, nbuf in VARIANTS:
            got = row_gather(table, ks[0], mode, unroll, nbuf)
            rows.append(dict(
                variant=name, N=n, mode=mode, unroll=unroll, nbuf=nbuf,
                equal=bool(torch.equal(got, ref)),
                fn=lambda k, m=mode, u=unroll, b=nbuf: row_gather(
                    table, k, m, u, b, check_index=False)))
        for r in rows:
            fn = r.pop("fn")
            ok = "OK" if r["equal"] else "WRONG"
            if dev.type == "cuda":
                ms = time_calls(fn, [(k,) for k in ks], REPS)
                r.update(ms=ms, ns_per_row=ms * 1e6 / n)
                print(f"{r['variant']:10}: {ms:8.3f} ms  "
                      f"{r['ns_per_row']:7.1f} ns/row  [{ok}]", flush=True)
            else:
                print(f"{r['variant']:10}: ran on {dev}, not timed  [{ok}]",
                      flush=True)
            out.append(r)
    return out


def main(argv: list[str] | None = None, device=None) -> list[dict]:
    return run(device=device)


if __name__ == "__main__":
    sys.exit(0 if all(r["equal"] for r in main()) else 1)
