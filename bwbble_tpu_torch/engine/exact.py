"""Lockstep exact backward search over a read batch.

Counterpart of bwbble_tpu/engine/exact.py: the device equivalent of
exact_match / exact_match_bounded (exact_match.c:58-222).  All reads advance
one character per step with masked inactive lanes; interval lists live in
fixed [B, K] arrays (see engine.intervals), in the index's arithmetic type
`didx.idt`.
"""

from __future__ import annotations

import torch

from bwbble_tpu_torch import constants as C
from bwbble_tpu_torch.engine import index_device
from bwbble_tpu_torch.engine.device_index import DeviceIndex
from bwbble_tpu_torch.engine.intervals import expand_step
from bwbble_tpu_torch.engine.rank import rank1_pair


def exact_search(didx: DeviceIndex, seq, lengths, K: int = 16, device=None):
    """Multi-genome exact search of full reads (exact_match.c:58-60).

    Args: seq int8/int32 [B, Lmax] nt4 codes (padded); lengths int32 [B].
    Returns (Ls, Us, cnt, overflow): interval lists per lane; overflow lanes
    must be recomputed on the host.
    """
    dev = index_device(didx, device)
    seq = torch.as_tensor(seq).to(dev).to(torch.int32)
    lengths = torch.as_tensor(lengths).to(dev).to(torch.int32)
    B, Lmax = seq.shape
    Ls = torch.zeros((B, K), dtype=didx.idt, device=dev)
    Us = torch.full((B, K), -1, dtype=didx.idt, device=dev)
    Us[:, 0] = didx.length - 1
    cnt = torch.ones((B,), dtype=torch.int32, device=dev)
    over = torch.zeros((B,), dtype=torch.bool, device=dev)
    four = torch.full((B,), 4, dtype=torch.int32, device=dev)

    for s in range(Lmax):
        r = lengths - 1 - s
        active = (r >= 0) & (cnt > 0)
        c = torch.where(active,
                        seq.gather(1, r.clamp(min=0).long()[:, None])[:, 0],
                        four)
        nLs, nUs, ncnt, _w, ov = expand_step(didx, Ls, Us, cnt, c)
        Ls = torch.where(active[:, None], nLs, Ls)
        Us = torch.where(active[:, None], nUs, Us)
        cnt = torch.where(active, ncnt, cnt)
        over = over | (active & ov)
    return Ls, Us, cnt, over


def exact_search_1to1(didx: DeviceIndex, seq, lengths, device=None):
    """Single-interval backward search on a 4-letter reference
    (exact_match_1to1_bounded, exact_match.c:196-222).  Returns (L, U,
    alive): the surviving interval per lane and whether it is non-empty."""
    dev = index_device(didx, device)
    seq = torch.as_tensor(seq).to(dev).to(torch.int32)
    lengths = torch.as_tensor(lengths).to(dev).to(torch.int32)
    B, Lmax = seq.shape
    gray = torch.tensor(C.NT4_GRAY, dtype=torch.int32, device=dev)
    L = torch.zeros((B,), dtype=didx.idt, device=dev)
    U = torch.full((B,), didx.length - 1, dtype=didx.idt, device=dev)
    alive = torch.ones((B,), dtype=torch.bool, device=dev)
    for s in range(Lmax):
        r = lengths - 1 - s
        active = alive & (r >= 0)
        cr = seq.gather(1, r.clamp(min=0).long()[:, None])[:, 0]
        is_n = cr > 3
        c = gray[cr.clamp(0, 4).long()]
        occL, occU = rank1_pair(didx, c, L - 1, U)
        Cc = didx.Carr[c.long()]
        nL = Cc + occL + 1
        nU = Cc + occU
        ok = active & ~is_n & (nL <= nU)
        dead = active & (is_n | (nL > nU))
        L = torch.where(ok, nL, L)
        U = torch.where(ok, nU, U)
        alive = alive & ~dead
    return L, U, alive
