"""Batched FM-index rank ops on the fused table.

Counterpart of bwbble_tpu/engine/rank.py.  Each function takes a vector of
BWT positions and returns occurrence bounds for the whole batch: one row
gather per query, then XNOR-AND + popcount over the four bit planes.

Two 16-symbol variants exist on purpose:
- `rank_all_exact`: true counts for every symbol (exact search, D bounds);
- `rank_all_dfs`: the inexact-search semantics, where the three-base codes
  B/H/V/D get no in-block counts (quirk Q1, bwt.c:698-734) yet still see
  the checkpoint-first-char decrement, and where the i == -1 and
  i == length-1 edge paths return full counts for all symbols.

Returned values are fully formed interval bounds:
occ[j] = C[j] + O(j, i) + inc, in the index's arithmetic type `didx.idt`
(int32, or int64 for the whole-genome layout, whose checkpoint counts are
split into low and high words: ck = hi << 32 | lo).
"""

from __future__ import annotations

import numpy as np
import torch

from bwbble_tpu_torch import constants as C
from bwbble_tpu_torch.engine.device_index import BLK, DeviceIndex

_SKIP_MASK = np.zeros(16, dtype=bool)
for _j in C.SKIPPED_ORDERS:
    _SKIP_MASK[_j] = True

# bit t of code j, as [16 codes, 4 bits]
_CODE_BITS = np.array([[(j >> t) & 1 for t in range(4)] for j in range(16)],
                      dtype=bool)


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Bit count of int32 words (SWAR; the masks make the arithmetic
    right shift harmless)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x & 0xFF) + ((x >> 8) & 0xFF) + ((x >> 16) & 0xFF)
            + ((x >> 24) & 0xFF))


def _take_rows(didx: DeviceIndex, k: torch.Tensor) -> torch.Tensor:
    """Rows of the fused table at global block ids k.

    On a tp-sharded index (`didx.tp_tables`) each shard holds a contiguous
    block range: each shard gathers on its own device, its rows outside
    its range are masked to zero on the query's device and the shards'
    rows summed there (exactly one shard owns each row), as the JAX
    package's psum over tp does."""
    if didx.tp_tables is None:
        return didx.table.index_select(0, k.long())
    nloc = didx.tp_tables[0].shape[0]
    rows = None
    for t, shard in enumerate(didx.tp_tables):
        lk = k.long() - t * nloc
        mine = ((lk >= 0) & (lk < nloc)).to(k.device)
        r = shard.index_select(0, lk.clamp(0, nloc - 1).to(shard.device))
        r = torch.where(mine[:, None], r.to(k.device), 0)
        rows = r if rows is None else rows + r
    return rows


def _gather_block(didx: DeviceIndex, i: torch.Tensor):
    """Clamp i into the normal-path domain and fetch (bit-plane words
    [B, 4, 4], checkpoint row [B, 16], in-block offset, first char) with one
    row gather from the fused table."""
    len_m1 = didx.length - 1
    i_c = i.clamp(0, max(len_m1 - 1, 0))
    k = torch.div(i_c, BLK, rounding_mode="floor")
    off = (i_c - k * BLK).to(torch.int32)
    rows = _take_rows(didx, k)                               # [B, 32|48]
    pw = rows[:, :16].reshape(-1, 4, 4)                      # [B, bit, word]
    if didx.idt == torch.int64:
        lo = rows[:, 16:32].to(torch.int64) & 0xFFFFFFFF
        ck = (rows[:, 32:48].to(torch.int64) << 32) | lo     # [B, 16] i64
    else:
        ck = rows[:, 16:32]
    first = ((pw[:, 0, 0] & 1) | ((pw[:, 1, 0] & 1) << 1)
             | ((pw[:, 2, 0] & 1) << 2) | ((pw[:, 3, 0] & 1) << 3))
    return pw, ck, off, first


def _prefix_masks(off: torch.Tensor) -> torch.Tensor:
    """[B, 4] word masks selecting bit positions 0..off within the block."""
    w = torch.arange(4, dtype=torch.int64, device=off.device)
    nbits = off.long()[:, None] + 1 - 32 * w[None, :]
    partial = (torch.ones_like(nbits) << nbits.clamp(0, 31)) - 1
    m = torch.where(nbits >= 32, torch.full_like(nbits, 0xFFFFFFFF),
                    torch.where(nbits <= 0, torch.zeros_like(nbits),
                                partial))
    # reinterpret the low 32 bits as int32
    return torch.where(m >= 2**31, m - 2**32, m).to(torch.int32)


def _block_counts(pw: torch.Tensor, off: torch.Tensor) -> torch.Tensor:
    """counts[b, j] = #positions p <= off[b] in the block with code j."""
    masks = _prefix_masks(off)                               # [B, 4]
    jb = torch.from_numpy(_CODE_BITS).to(pw.device)          # [16, 4]
    sel = torch.where(jb[None, :, :, None], pw[:, None, :, :],
                      ~pw[:, None, :, :])                    # [B, 16, 4, 4]
    m = sel[:, :, 0, :] & sel[:, :, 1, :] & sel[:, :, 2, :] & sel[:, :, 3, :]
    return popcount32(m & masks[:, None, :]).sum(dim=2).to(torch.int32)


def _block_count1(pw: torch.Tensor, off: torch.Tensor,
                  c: torch.Tensor) -> torch.Tensor:
    """counts[b] = #positions p <= off[b] with code c[b]."""
    masks = _prefix_masks(off)
    cb = torch.from_numpy(_CODE_BITS).to(pw.device)[c.long()]  # [B, 4]
    sel = torch.where(cb[:, :, None], pw, ~pw)               # [B, 4, 4]
    m = sel[:, 0, :] & sel[:, 1, :] & sel[:, 2, :] & sel[:, 3, :]
    return popcount32(m & masks).sum(dim=1).to(torch.int32)


def _rank_all(didx: DeviceIndex, i: torch.Tensor, inc, dfs: bool
              ) -> torch.Tensor:
    """inc may be a scalar or a per-query [B] vector."""
    idt = didx.idt
    i = i.to(idt)
    if not torch.is_tensor(inc):
        inc = torch.full_like(i, int(inc))
    inc = inc.to(idt)[:, None]
    len_m1 = didx.length - 1
    pw, ck, off, first = _gather_block(didx, i)
    cnt = _block_counts(pw, off).to(idt)
    sym = torch.arange(16, dtype=torch.int32, device=i.device)
    first_dec = (first[:, None] == sym[None, :]).to(idt)
    Cv = didx.Carr[:16][None, :]

    normal = Cv + ck + cnt + inc - first_dec
    if dfs:
        skipped = Cv + inc - first_dec
        skip = torch.from_numpy(_SKIP_MASK).to(i.device)
        normal = torch.where(skip[None, :], skipped, normal)
    low = Cv + inc                                # i == -1
    high = didx.Carr[1:17][None, :] + inc         # i == length-1
    out = torch.where((i == len_m1)[:, None], high,
                      torch.where((i < 0)[:, None], low, normal))
    out[:, 0] = 0
    return out


def rank_all_exact(didx: DeviceIndex, i: torch.Tensor, inc) -> torch.Tensor:
    """[B] positions -> [B, 16] bounds with true counts for all symbols."""
    return _rank_all(didx, i, inc, dfs=False)


def rank_all_dfs(didx: DeviceIndex, i: torch.Tensor, inc) -> torch.Tensor:
    """[B] positions -> [B, 16] bounds with inexact-search (Q1) semantics."""
    return _rank_all(didx, i, inc, dfs=True)


def _project_actg(full: torch.Tensor) -> torch.Tensor:
    """[B, 16] exact bounds -> [B, 5]: slots 1..4 = A, G, C, T."""
    gray = torch.tensor(C.NT4_GRAY[:4], dtype=torch.int64,
                        device=full.device)
    out = torch.zeros((full.shape[0], 5), dtype=full.dtype,
                      device=full.device)
    out[:, 1:5] = full.index_select(1, gray)
    return out


def rank_actg_dfs(didx: DeviceIndex, i: torch.Tensor, inc) -> torch.Tensor:
    """[B] -> [B, 5]; slots 1..4 = A,G,C,T bounds for single-genome mode
    (O_actg_alphabet, bwt.c:440-463).  The in-block scan is exact for the
    four pure-base symbols, so this is a projection of rank_all_exact."""
    return _project_actg(_rank_all(didx, i, inc, dfs=False))


def rank1(didx: DeviceIndex, c: torch.Tensor, i: torch.Tensor
          ) -> torch.Tensor:
    """Single-char rank O(c, i) per lane (bwt.c:348-372), including the
    sentinel-row exclusion for c == 0 (bwt.c:360-369)."""
    idt = didx.idt
    c = c.to(torch.int32)
    i = i.to(idt)
    len_m1 = didx.length - 1
    pw, ck, off, first = _gather_block(didx, i)
    base = torch.div(i, BLK, rounding_mode="floor") * BLK
    cnt = _block_count1(pw, off, c).to(idt)
    ckc = ck.gather(1, c.long()[:, None])[:, 0]
    sentinel = ((c == 0) & (base < didx.sa0) & (didx.sa0 <= i)).to(idt)
    normal = ckc + cnt - (first == c).to(idt) - sentinel
    high = didx.Carr[(c + 1).long()] - didx.Carr[c.long()]
    return torch.where(i == len_m1, high,
                       torch.where(i < 0, torch.zeros_like(normal), normal))


def _pair(didx, iL, iU, dfs):
    B = iL.shape[0]
    iL = iL.to(didx.idt)
    iU = iU.to(didx.idt)
    inc = torch.cat([torch.ones_like(iL), torch.zeros_like(iU)])
    out = _rank_all(didx, torch.cat([iL, iU]), inc, dfs=dfs)
    return out[:B], out[B:]


def rank_all_dfs_pair(didx: DeviceIndex, iL: torch.Tensor, iU: torch.Tensor):
    """Fused (O_alphabet(L-1)+1, O_alphabet(U)) pair: one gather of 2B rows
    (the two calls of inexact_match.c:379-385)."""
    return _pair(didx, iL, iU, True)


def rank_all_exact_pair(didx: DeviceIndex, iL: torch.Tensor,
                        iU: torch.Tensor):
    """Fused exact-variant pair (bounds at L-1 with +1, at U with +0)."""
    return _pair(didx, iL, iU, False)


def rank_actg_dfs_pair(didx: DeviceIndex, iL: torch.Tensor,
                       iU: torch.Tensor):
    """Fused single-genome pair: [B, 5] bounds at L-1 (+1) and at U (+0)."""
    full_L, full_U = _pair(didx, iL, iU, False)
    return _project_actg(full_L), _project_actg(full_U)


def rank1_pair(didx: DeviceIndex, c: torch.Tensor, iL: torch.Tensor,
               iU: torch.Tensor):
    """Fused single-char rank at two positions per lane."""
    out = rank1(didx, torch.cat([c, c]), torch.cat([iL, iU]))
    B = c.shape[0]
    return out[:B], out[B:]


def bwt_char(didx: DeviceIndex, i: torch.Tensor) -> torch.Tensor:
    """B(i) per lane (bwt.c:337-345); returns int32 codes."""
    i = i.to(didx.idt)
    k = torch.div(i, BLK, rounding_mode="floor")
    off = (i - k * BLK).to(torch.int32)
    pw = _take_rows(didx, k)[:, :16].reshape(-1, 4, 4)
    w = torch.div(off, 32, rounding_mode="floor")
    b = off - w * 32
    bits = pw.gather(2, w.long()[:, None, None].expand(-1, 4, 1))[:, :, 0]
    bits = (bits >> b[:, None]) & 1
    return (bits[:, 0] | (bits[:, 1] << 1) | (bits[:, 2] << 2)
            | (bits[:, 3] << 3))


def inv_psi(didx: DeviceIndex, i: torch.Tensor) -> torch.Tensor:
    """LF step per lane (invPsi, bwt.c:311-317)."""
    i = i.to(didx.idt)
    c = bwt_char(didx, i)
    step = didx.Carr[c.long()] + rank1(didx, c, i)
    return torch.where(i == didx.sa0, torch.zeros_like(step), step)


def sa_resolve(didx: DeviceIndex, rows: torch.Tensor) -> torch.Tensor:
    """Batched SA lookup: walk invPsi to a sampled row (SA, bwt.c:320-329).

    Samples are stored at rows = 0 (mod SA_INTERVAL), so the lockstep walk
    length is geometric with mean SA_INTERVAL; all lanes run until every one
    has parked on a sampled row (one host check per step)."""
    i = rows.to(didx.table.device).to(didx.idt)
    j = torch.zeros_like(i)
    while True:
        moving = (i % C.SA_INTERVAL) != 0
        if not bool(moving.any()):
            break
        i = torch.where(moving, inv_psi(didx, i), i)
        j = j + moving.to(didx.idt)
    vals = didx.sa_samples[torch.div(i, C.SA_INTERVAL,
                                     rounding_mode="floor").long()]
    return (vals + j) % didx.length
