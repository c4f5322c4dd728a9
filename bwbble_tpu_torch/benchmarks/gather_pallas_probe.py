"""Probe: the search loop's gather -> layout -> consumer chain in isolation.

    python -m bwbble_tpu_torch.benchmarks.gather_pallas_probe

Counterpart of benchmarks/gather_pallas_probe.py (its four Pallas consumers
are the TPU kernel K5; here `kernels.digest_consume`, csrc/probes.cu).  Each
iteration gathers RQ * B rows of a [N, 32 | 128] int32 table at indices k
[RQ, B], lays them out as the consumer demands, reduces them to an [8, B]
digest d[w, b] = sum over q of row (q, b) word w, and sets
k = (k + d[:RQ]) mod N, so the next gather depends on this one's rows.  The
gather and the layout are torch ops outside the kernel, as the JAX package
does them in XLA outside its kernel: what the probe times is the layout the
consumer forces onto the gather.

Variants (all RQ = 6 unless named, B = 1 024, 200 iterations):
  take      index_select [R, 32] -> permute -> lane-major [RQ * 32, B]
  gatherT   a gather that emits [RQ, 32, B] directly -> lane-major
  rowmajor  index_select [R, 32], stream-major rows
  pad128    a table padded to 128 words, stream-major [R, 128]
  pad128g3  pad128 as [RQ, B, 128], consumed in blocks of 256 lanes
  take_rq4, take_rq2   take at RQ = 4 and 2

Fault C4 of the JAX probe: its loops add d[:6, :] to k of shape [RQ, B],
which JAX refuses to broadcast for RQ != 6, so `run_rq(4)` dies there.  This
loop adds d[:RQ], the same thing at RQ = 6.

Tables and k0 are random (words in [0, 2^30)) and made on the card from a
seed.  Timed with CUDA events after one warm-up loop; prints us an
iteration and ns a row.  With device="cpu" (the tests) the plain version
runs and nothing is timed.
"""

from __future__ import annotations


import torch

from bwbble_tpu_torch.benchmarks.kernels import digest_consume, time_calls
from bwbble_tpu_torch.engine import resolve_device

N = 913_021
B = 1024
RQ = 6
W = 32
ITERS = 200
# variant -> (RQ, table words, layout the consumer reads)
VARIANTS = {
    "take": (RQ, W, "lane_major"),
    "gatherT": (RQ, W, "lane_major"),
    "rowmajor": (RQ, W, "row_major"),
    "pad128": (RQ, 128, "row_major_128"),
    "pad128g3": (RQ, 128, "blocked_128"),
    "take_rq4": (4, W, "lane_major"),
    "take_rq2": (2, W, "lane_major"),
}


def gather_rows(variant: str, table: torch.Tensor, k: torch.Tensor
                ) -> torch.Tensor:
    """The rows at k [RQ, B] in the layout `variant`'s consumer reads."""
    rq, b = k.shape
    flat = k.reshape(-1).to(torch.int64)
    if variant == "gatherT":
        n, w = table.shape
        src = table.t().unsqueeze(0).expand(rq, w, n)
        idx = k.to(torch.int64)[:, None, :].expand(rq, w, b)
        return torch.gather(src, 2, idx).reshape(rq * w, b)
    rows = table.index_select(0, flat)
    if VARIANTS[variant][2] == "lane_major":
        return rows.reshape(rq, b, -1).permute(0, 2, 1).reshape(-1, b)
    if variant == "pad128g3":
        return rows.reshape(rq, b, -1)
    return rows


def step(variant: str, table: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """One iteration: gather, digest, next indices (int32 wrapping sum,
    floor modulo N)."""
    rq, b = k.shape
    d = digest_consume(gather_rows(variant, table, k), VARIANTS[variant][2],
                       rq, b)
    s = k.to(torch.int64) + d[:rq].to(torch.int64)
    s = ((s + 2**31) % 2**32) - 2**31
    return (s % table.shape[0]).to(torch.int32)


def loop(variant: str, table: torch.Tensor, k0: torch.Tensor,
         iters: int = ITERS) -> torch.Tensor:
    k = k0
    for _ in range(iters):
        k = step(variant, table, k)
    return k


def make_inputs(variant: str, device, n: int = N, b: int = B,
                seed: int = 0):
    """(table, k0) of `variant` on `device`, from `seed`."""
    rq, w, _ = VARIANTS[variant]
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    table = torch.randint(0, 1 << 30, (n, w), generator=g, device=device,
                          dtype=torch.int32)
    k0 = torch.randint(0, n, (rq, b), generator=g, device=device,
                       dtype=torch.int32)
    return table, k0


def run(variant: str, device=None, iters: int = ITERS, n: int = N,
        b: int = B, seed: int = 0) -> dict:
    """One variant: its final k and, on the card, us an iteration and ns a
    row."""
    dev = resolve_device(device)
    table, k0 = make_inputs(variant, dev, n, b, seed)
    rq = VARIANTS[variant][0]
    res = dict(variant=variant, RQ=rq, B=b, N=n, iters=iters,
               layout=VARIANTS[variant][2], k=loop(variant, table, k0, iters))
    if dev.type == "cuda":
        ms = time_calls(lambda: loop(variant, table, k0, iters), [()], 1)
        us = ms * 1e3 / iters
        res.update(ms=ms, us_per_iter=us, ns_per_row=us * 1e3 / (rq * b))
        print(f"{variant:8}: {us:7.1f} us/iter ({res['ns_per_row']:5.2f} "
              "ns/row)", flush=True)
    else:
        print(f"{variant:8}: ran on {dev}, not timed", flush=True)
    return res


def main(argv: list[str] | None = None, device=None) -> list[dict]:
    return [run(v, device=device) for v in VARIANTS]


if __name__ == "__main__":
    main()
