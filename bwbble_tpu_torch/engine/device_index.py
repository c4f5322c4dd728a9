"""Device-resident FM-index layout (int32).

Counterpart of bwbble_tpu/engine/device_index.py, int32 layout only: one
fused 128-byte row per 128-position BWT block, so a rank query is a single
row read:

  cols 0..15  — bit planes: table[k, 4*t + w] holds bit t of the codes at
                positions w*32 .. w*32+31 of block k (LSB-first); XNOR-AND
                + popcount answers a 16-symbol rank with 64 popcounts;
  cols 16..31 — occurrence-checkpoint counts of the 16 symbols.

The int64 whole-genome layout is not ported yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from bwbble_tpu_torch import constants as C
from bwbble_tpu_torch.engine import resolve_device
from bwbble_tpu_torch.index.fmindex import FMIndex

BLK = C.OCC_INTERVAL  # 128 positions per block


@dataclasses.dataclass
class DeviceIndex:
    table: torch.Tensor       # int32 [num_blocks, 32] fused rows
    Carr: torch.Tensor        # int32 [17] prefix counts
    sa_samples: torch.Tensor  # int32 [num_sa] SA values every SA_INTERVAL
    length: int               # BWT length (host scalar: no device sync)
    sa0: int                  # sentinel row

    @property
    def num_blocks(self) -> int:
        return self.table.shape[0]

    @property
    def device(self) -> torch.device:
        return self.table.device


def build_planes(blocks: np.ndarray) -> np.ndarray:
    """Pack int8 code blocks [NB, 128] into bit planes [NB, 16] int32:
    packbits(bitorder='little') + a <u4 view puts bit position p%32 of
    word p//32 exactly where the rank ops expect it."""
    nb = blocks.shape[0]
    u = blocks.view(np.uint8)
    planes = np.zeros((nb, 4, 4), dtype=np.uint32)        # [NB, bit t, word w]
    for t in range(4):
        planes[:, t, :] = np.packbits((u >> t) & 1, axis=1,
                                      bitorder="little").view("<u4")
    return planes.reshape(nb, 16).view(np.int32)


def from_arrays(table, Carr, sa_samples, length, sa0,
                device=None) -> DeviceIndex:
    """DeviceIndex from the numpy form of the fields (the JAX package's
    DeviceIndex fields convert with np.asarray), so both engines can be
    fed the very same index."""
    dev = resolve_device(device)
    table = np.array(table, dtype=np.int32)   # a writable copy
    if table.ndim != 2 or table.shape[1] != 32:
        raise NotImplementedError(
            "only the int32 layout ([num_blocks, 32] fused rows) is "
            "ported; the int64 whole-genome layout is not")
    return DeviceIndex(
        table=torch.from_numpy(table).to(dev),
        Carr=torch.from_numpy(
            np.array(Carr, dtype=np.int32)).to(dev),
        sa_samples=torch.from_numpy(
            np.array(sa_samples, dtype=np.int32)).to(dev),
        length=int(length), sa0=int(sa0))


def from_fmindex(idx: FMIndex, device=None) -> DeviceIndex:
    """Device layout for an FM-index (int32: up to 2^31 positions)."""
    dev = resolve_device(device)
    if idx.length >= 2**31:
        raise NotImplementedError(
            "index has >= 2^31 positions: the int64 device layout is not "
            "ported yet")
    num_blocks = -(-idx.length // BLK)
    blocks = np.zeros((num_blocks, BLK), dtype=np.int8)
    blocks.reshape(-1)[:idx.length] = idx.bwt
    planes = build_planes(blocks)
    table = np.concatenate([planes, idx.occ.astype(np.int32)], axis=1)
    return from_arrays(table, idx.Carr, idx.sa, idx.length, idx.sa0, dev)
