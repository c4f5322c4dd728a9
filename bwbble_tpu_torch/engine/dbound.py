"""Lockstep lower-bound (D) computation.

Counterpart of bwbble_tpu/engine/dbound.py: the device equivalent of
calculate_d (inexact_match.c:171-254), a forward-direction exact scan of
the read that counts how many times the match set empties (z) and the
surviving SA width per position.  Multi-genome mode runs over interval
lists (engine.intervals); single-genome mode is a one-interval walk.
Output D[b, t] = (num_diff, sa_intv_width) for t in [0, read_len], indexed
from the read's end like the reference.
"""

from __future__ import annotations

import torch

from bwbble_tpu_torch import constants as C
from bwbble_tpu_torch.engine import index_device
from bwbble_tpu_torch.engine.device_index import DeviceIndex
from bwbble_tpu_torch.engine.intervals import expand_step
from bwbble_tpu_torch.engine.rank import rank1_pair


def calc_d(didx: DeviceIndex, seq, lengths, K: int = 32,
           max_len: int | None = None, device=None):
    """Multi-genome D bounds.  Returns (D [B, max_len+1, 2] in the index's
    type didx.idt, overflow bool [B]); D[b, t] = (num_diff,
    sa_intv_width).  seq/lengths
    may be numpy arrays or tensors; they are moved to `device` (None means
    CUDA), which must be where the index lives."""
    dev = index_device(didx, device)
    seq = torch.as_tensor(seq).to(dev).to(torch.int32)
    lengths = torch.as_tensor(lengths).to(dev).to(torch.int32)
    B, Lmax = seq.shape
    max_len = Lmax if max_len is None else max_len
    full_w = didx.length  # (length-1) - 0 + 1

    idt = didx.idt
    D = torch.zeros((B, max_len + 1, 2), dtype=idt, device=dev)
    Ls0 = torch.zeros((B, K), dtype=idt, device=dev)
    Us0 = torch.full((B, K), -1, dtype=idt, device=dev)
    Us0[:, 0] = didx.length - 1
    Ls, Us = Ls0, Us0
    cnt = torch.ones((B,), dtype=torch.int32, device=dev)
    z = torch.zeros((B,), dtype=idt, device=dev)
    over = torch.zeros((B,), dtype=torch.bool, device=dev)
    four = torch.full((B,), 4, dtype=torch.int32, device=dev)

    for s in range(min(Lmax, max_len)):
        r = lengths - 1 - s
        active = r >= 0
        c = torch.where(active,
                        seq.gather(1, r.clamp(min=0).long()[:, None])[:, 0],
                        four)
        nLs, nUs, ncnt, w, ov = expand_step(didx, Ls, Us, cnt, c)
        empty = ncnt == 0
        # on empty: reset to the full range, count a difference, and report
        # the full width (inexact_match.c:239-244)
        nz = z + empty.to(idt)
        nLs = torch.where(empty[:, None], Ls0, nLs)
        nUs = torch.where(empty[:, None], Us0, nUs)
        ncnt = torch.where(empty, torch.ones_like(ncnt), ncnt)
        w = torch.where(empty, torch.full_like(w, full_w), w)
        row = torch.where(active[:, None], torch.stack([nz, w], dim=1),
                          D[:, s, :])
        D[:, s, :] = row
        Ls = torch.where(active[:, None], nLs, Ls)
        Us = torch.where(active[:, None], nUs, Us)
        cnt = torch.where(active, ncnt, cnt)
        z = torch.where(active, nz, z)
        over = over | (active & ov)

    # D[read_len] = (z+1, 0)  (inexact_match.c:249-250)
    tail = torch.stack([z + 1, torch.zeros_like(z)], dim=1)
    D[torch.arange(B, device=dev), lengths.clamp(0, max_len).long()] = tail
    return D, over


def calc_d_1to1(didx: DeviceIndex, seq, lengths, max_len: int | None = None,
                device=None):
    """Single-genome D bounds (inexact_match.c:176-205).  Same returns as
    calc_d; the overflow flags are all false (one interval never
    overflows)."""
    dev = index_device(didx, device)
    seq = torch.as_tensor(seq).to(dev).to(torch.int32)
    lengths = torch.as_tensor(lengths).to(dev).to(torch.int32)
    B, Lmax = seq.shape
    max_len = Lmax if max_len is None else max_len
    gray = torch.tensor(C.NT4_GRAY, dtype=torch.int32, device=dev)
    last = didx.length - 1

    idt = didx.idt
    D = torch.zeros((B, max_len + 1, 2), dtype=idt, device=dev)
    L = torch.zeros((B,), dtype=idt, device=dev)
    U = torch.full((B,), last, dtype=idt, device=dev)
    z = torch.zeros((B,), dtype=idt, device=dev)
    for s in range(min(Lmax, max_len)):
        r = lengths - 1 - s
        active = r >= 0
        cr = seq.gather(1, r.clamp(min=0).long()[:, None])[:, 0]
        c = gray[cr.clamp(0, 4).long()]
        is_n = c == C.ORDER_N
        occL, occU = rank1_pair(didx, c, L - 1, U)
        Cc = didx.Carr[c.long()]
        nL = Cc + occL + 1
        nU = Cc + occU
        miss = is_n | (nL > nU)
        nz = z + miss.to(idt)
        nL = torch.where(miss, torch.zeros_like(nL), nL)
        nU = torch.where(miss, torch.full_like(nU, last), nU)
        row = torch.where(active[:, None],
                          torch.stack([nz, nU - nL + 1], dim=1), D[:, s, :])
        D[:, s, :] = row
        L = torch.where(active, nL, L)
        U = torch.where(active, nU, U)
        z = torch.where(active, nz, z)
    tail = torch.stack([z + 1, torch.zeros_like(z)], dim=1)
    D[torch.arange(B, device=dev), lengths.clamp(0, max_len).long()] = tail
    return D, torch.zeros((B,), dtype=torch.bool, device=dev)
