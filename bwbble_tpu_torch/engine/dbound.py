"""Lockstep lower-bound (D) computation.

Counterpart of bwbble_tpu/engine/dbound.py: the device equivalent of
calculate_d (inexact_match.c:171-254), a forward-direction exact scan of
the read that counts how many times the match set empties (z) and the
surviving SA width per position.  Multi-genome mode runs over interval
lists (engine.intervals); single-genome mode is a one-interval walk.
Output D[b, t] = (num_diff, sa_intv_width) for t in [0, read_len], indexed
from the read's end like the reference.  A chunk's D and D_seed passes
are one launch of a hand-written kernel on a CUDA index (calc_d_chunk,
calc_d_1to1_chunk); calc_d and calc_d_1to1 are their plain versions.
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


def calc_d_chunk(didx: DeviceIndex, seq, lengths, seed_len: int, K: int):
    """D and D_seed bounds of a chunk of multi-genome reads at list capacity
    K, the multi-genome pass of engine/dpass.py:chunk_bounds: (D [B,
    Lmax+1, 2], Ds [B, max(seed_len, 1)+1, 2] in the index's type, overflow
    bool [B]: D's, or D_seed's where the read uses a seed).  Ds as for
    calc_d_1to1_chunk.  On a CUDA index one launch of the hand-written
    kernel (engine/kernel.py:dbound_mg; seq int8 and lengths int32 on its
    card); on the CPU the plain version."""
    if didx.device.type == "cuda":
        from bwbble_tpu_torch.engine import kernel
        return kernel.dbound_mg(didx, seq, lengths, seed_len, K)
    return calc_d_chunk_plain(didx, seq, lengths, seed_len, K)


def calc_d_chunk_plain(didx: DeviceIndex, seq, lengths, seed_len: int,
                       K: int):
    """The plain version of calc_d_chunk, on the index's device: calc_d for
    D and again for D_seed, masked."""
    dev = didx.device
    seq = torch.as_tensor(seq).to(dev)
    lengths = torch.as_tensor(lengths).to(dev).to(torch.int32)
    use_seed = (lengths > seed_len) & (seed_len > 0)
    sl = torch.where(use_seed, seed_len, 0).to(torch.int32)
    D, dov1 = calc_d(didx, seq, lengths, K=K, device=dev)
    Ds, dov2 = calc_d(didx, seq, sl, K=K, max_len=max(seed_len, 1),
                      device=dev)
    # reads not using a seed keep an all-zero D_seed (calloc semantics,
    # inexact_match.c:36,62-64)
    Ds = torch.where(use_seed[:, None, None], Ds, torch.zeros_like(Ds))
    return D, Ds, dov1 | (dov2 & use_seed)


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


def calc_d_1to1_chunk(didx: DeviceIndex, seq, lengths, seed_len: int):
    """D and D_seed bounds of a chunk of single-genome reads, the `-S` pass
    of engine/dpass.py:chunk_bounds: (D [B, Lmax+1, 2], Ds [B,
    max(seed_len, 1)+1, 2] in the index's type, overflow bool [B], all
    false).  Ds is the bound of a read's first seed_len bases for a read
    longer than seed_len, all zero for the others (calloc semantics,
    inexact_match.c:36,62-64).  On a CUDA index one launch of the
    hand-written kernel (engine/kernel.py:dbound_1to1; seq int8 and lengths
    int32 on its card); on the CPU the plain version."""
    if didx.device.type == "cuda":
        from bwbble_tpu_torch.engine import kernel
        return kernel.dbound_1to1(didx, seq, lengths, seed_len)
    return calc_d_1to1_chunk_plain(didx, seq, lengths, seed_len)


def calc_d_1to1_chunk_plain(didx: DeviceIndex, seq, lengths, seed_len: int):
    """The plain version of calc_d_1to1_chunk, on the index's device:
    calc_d_1to1 for D and again for D_seed, masked."""
    dev = didx.device
    seq = torch.as_tensor(seq).to(dev)
    lengths = torch.as_tensor(lengths).to(dev).to(torch.int32)
    use_seed = (lengths > seed_len) & (seed_len > 0)
    sl = torch.where(use_seed, seed_len, 0).to(torch.int32)
    D, _ = calc_d_1to1(didx, seq, lengths, device=dev)
    Ds, _ = calc_d_1to1(didx, seq, sl, max_len=max(seed_len, 1), device=dev)
    Ds = torch.where(use_seed[:, None, None], Ds, torch.zeros_like(Ds))
    return D, Ds, torch.zeros((seq.shape[0],), dtype=torch.bool, device=dev)
