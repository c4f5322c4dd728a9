"""Lockstep SA-interval-list expansion.

Counterpart of bwbble_tpu/engine/intervals.py.  The reference keeps
per-read linked lists of disjoint sorted SA intervals (sa_intv_list_t,
align.c:34-46) and expands each interval by the <=7 IUPAC symbols matching
the next read base (exact_match.c:88-109).  Here a batch of reads holds
fixed-capacity interval arrays [B, K]; one expansion step is:

1. batched rank_all_exact at (L-1) and U for every slot — [B*K] queries;
2. pick the 7 candidate bounds per lane from the per-slot rank vectors;
3. order-preserving compaction + adjoining-interval merge (the merge
   semantics of add_sa_interval, align.c:93-110).

Candidate order (slot-major, base-minor) reproduces the reference's list
construction order, so compacted lists are element-for-element identical.
Capacity overflow sets a per-lane flag.
"""

from __future__ import annotations

import numpy as np
import torch

from bwbble_tpu_torch import constants as C
from bwbble_tpu_torch.engine.device_index import DeviceIndex
from bwbble_tpu_torch.engine.rank import rank_all_exact_pair

_NUCL = np.asarray(C.NUCL_BASES, dtype=np.int64)          # [4, 7]
_NB = C.BASES_PER_NUCLEOTIDE


def expand_step(didx: DeviceIndex, Ls: torch.Tensor, Us: torch.Tensor,
                cnt: torch.Tensor, c: torch.Tensor, cap: int | None = None):
    """One backward-search step over interval lists.

    Args:  Ls/Us [B, K] in the index's type didx.idt; cnt int32 [B]; c
           int32 [B] nt4 read base; cap: the new lists' capacity (None: K).
           A caller may pass only the first columns of its lists, as long
           as they hold every live slot (cnt <= K), with its capacity as
           `cap`: the result is the same.
    Returns (newLs, newUs, newcnt, width_sum, overflow_step):
      newLs/newUs [B, cap];
      width_sum[b] = total width of the candidate intervals (the
      num_matches accumulator of calculate_d, inexact_match.c:226);
      overflow_step[b] = merged list exceeded cap.
    Lanes with c > 3 (N) produce empty lists (exact_match.c:84-86).
    """
    B, K = Ls.shape
    dev = Ls.device
    slot = torch.arange(K, dtype=torch.int32, device=dev)
    slot_live = slot[None, :] < cnt[:, None]
    # dead slots (>= cnt) query block 0: their outputs are masked out below
    qL = torch.where(slot_live, Ls - 1, torch.zeros_like(Ls)).reshape(-1)
    qU = torch.where(slot_live, Us, torch.zeros_like(Us)).reshape(-1)
    occL, occU = rank_all_exact_pair(didx, qL, qU)
    occL = occL.reshape(B, K, 16)
    occU = occU.reshape(B, K, 16)

    # cand[b, k, s] = occ[b, k, NUCL_BASES[c[b], s]]
    syms = torch.from_numpy(_NUCL).to(dev)[c.clamp(0, 3).long()]  # [B, 7]
    pick = syms[:, None, :].expand(B, K, _NB)
    candL = occL.gather(2, pick)
    candU = occU.gather(2, pick)

    valid = (slot_live[:, :, None] & (candL <= candU)
             & (c < 4)[:, None, None])
    width_sum = torch.where(valid, candU - candL + 1,
                            torch.zeros_like(candL)).sum(
                                dim=(1, 2)).to(Ls.dtype)

    newLs, newUs, newcnt, overflow = merge_compact(
        candL.reshape(B, K * _NB), candU.reshape(B, K * _NB),
        valid.reshape(B, K * _NB), K if cap is None else int(cap))
    return newLs, newUs, newcnt, width_sum, overflow


def merge_compact(candL: torch.Tensor, candU: torch.Tensor,
                  valid: torch.Tensor, K: int):
    """Order-preserving compaction of valid candidates with
    adjoining-interval merge, returning at most K merged intervals per lane
    (and whether more than K were needed)."""
    B, M = candL.shape
    dev = candL.device
    pos = torch.arange(M, dtype=torch.int64, device=dev)[None, :]
    # U of the previous valid candidate ("carry last valid value")
    last_idx = torch.where(valid, pos, torch.full_like(pos, -1)
                           ).cummax(dim=1).values
    prev_idx = torch.cat([torch.full((B, 1), -1, dtype=torch.int64,
                                     device=dev), last_idx[:, :-1]], dim=1)
    prevU = torch.where(prev_idx >= 0,
                        candU.gather(1, prev_idx.clamp(min=0)),
                        torch.full_like(candU, -2))
    head = valid & (candL != prevU + 1)
    gid = head.to(torch.int64).cumsum(dim=1) - 1
    newcnt = torch.where(valid, gid + 1, torch.zeros_like(gid)
                         ).amax(dim=1).to(torch.int32)

    # chain reductions into K slots (+1 trash column for overflow/invalid):
    # L of the chain head, max U of the chain
    tgt = torch.where(valid, gid.clamp(max=K), torch.full_like(gid, K))
    tgt_h = torch.where(head, tgt, torch.full_like(gid, K))
    Lout = torch.zeros((B, K + 1), dtype=candL.dtype, device=dev)
    Lout.scatter_(1, tgt_h, candL)
    Uout = torch.full((B, K + 1), -1, dtype=candU.dtype, device=dev)
    Uout.scatter_reduce_(1, tgt, candU, reduce="amax", include_self=True)

    overflow = newcnt > K
    newcnt = newcnt.clamp(max=K)
    live = torch.arange(K, dtype=torch.int32, device=dev)[None, :] \
        < newcnt[:, None]
    newLs = torch.where(live, Lout[:, :K], torch.zeros_like(Lout[:, :K]))
    newUs = torch.where(live, Uout[:, :K],
                        torch.full_like(Uout[:, :K], -1))
    return newLs, newUs, newcnt, overflow
