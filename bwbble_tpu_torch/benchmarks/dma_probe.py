"""Probe: dependent row fetches of B0 lanes, K waves in one kernel.

    python -m bwbble_tpu_torch.benchmarks.dma_probe [B0] [K]

Counterpart of benchmarks/dma_probe.py (its Pallas kernel `_make` is the
TPU kernel K4; here `kernels.dma_wave`, csrc/probes.cu).  The search kernels
of this design hinge on one number: how fast a lane can fetch a 512-byte
row of a large table at an index that the previous row decided, the DFS
chain of pops.  B0 lanes run K such waves back to back in one launch; wave
t + 1's row index is (idx + s) mod N with s from wave t's row.  At a small
B0 the time a wave is the card's latency of one dependent row fetch.

Variants:
  wave      s is the wrapping sum of the row's first 8 words;
  compute   s is a popcount digest of its first 32 words, about two
            rank16s of integer work a wave (does it hide under the fetch?).

Defaults B0 = 128, K = 256 and a table of N = 913 021 rows (the chr21-scale
fat-row count), random words in [0, 2^30) made on the card from a seed.
Timed with CUDA events over distinct warm and timed index sets; prints ms a
launch, us a wave and ns a row for each variant.  With device="cpu" (the
tests) the plain version runs and nothing is timed.
"""

from __future__ import annotations

import sys

import torch

from bwbble_tpu_torch.benchmarks.kernels import ROW_WORDS, dma_wave, time_calls
from bwbble_tpu_torch.engine import resolve_device

N = 913_021          # table rows (chr21-scale fat-row count)
W = ROW_WORDS        # row width in int32 words (512 B)
NB = 4               # timed index sets (one more warms up)
VARIANTS = (("wave", False), ("compute", True))


def make_inputs(B0: int, n: int, device, seed: int = 0, sets: int = NB + 1):
    """The table [n, 128] of random words in [0, 2^30) and `sets` index
    sets [8, B0] in [0, n), made on `device` from `seed`."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    tbl = torch.randint(0, 1 << 30, (n, W), generator=g, device=device,
                        dtype=torch.int32)
    idxs = [torch.randint(0, n, (8, B0), generator=g, device=device,
                          dtype=torch.int32) for _ in range(sets)]
    return tbl, idxs


def run(B0: int = 128, K: int = 256, device=None, n: int = N,
        seed: int = 0) -> list[dict]:
    """Both variants at (B0, K): one dict each with the output of the first
    index set and, on the card, ms a launch, us a wave and ns a row."""
    dev = resolve_device(device)
    tbl, idxs = make_inputs(B0, n, dev, seed)
    out = []
    for name, compute in VARIANTS:
        res = dict(variant=name, B0=B0, K=K, N=n,
                   out=dma_wave(idxs[0], tbl, K, compute))
        if dev.type == "cuda":
            # made in range above, checked in the first call
            ms = time_calls(lambda i: dma_wave(i, tbl, K, compute,
                                               check_index=False),
                            [(i,) for i in idxs], NB)
            res.update(ms=ms, us_per_wave=ms * 1e3 / max(K, 1),
                       ns_per_row=ms * 1e6 / max(K * B0, 1))
            print(f"{name:8} B0={B0} K={K}: {ms:8.2f} ms total, "
                  f"{res['us_per_wave']:7.2f} us/wave, "
                  f"{res['ns_per_row']:7.1f} ns/row", flush=True)
        else:
            print(f"{name:8} B0={B0} K={K}: ran on {dev}, not timed",
                  flush=True)
        out.append(res)
    return out


def main(argv: list[str] | None = None, device=None) -> list[dict]:
    argv = list(sys.argv[1:] if argv is None else argv)
    B0 = int(argv[0]) if len(argv) > 0 else 128
    K = int(argv[1]) if len(argv) > 1 else 256
    return run(B0, K, device=device)


if __name__ == "__main__":
    main()
