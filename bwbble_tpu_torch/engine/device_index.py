"""Device-resident FM-index layout.

Counterpart of bwbble_tpu/engine/device_index.py: one fused row per
128-position BWT block, so a rank query is a single row read:

  cols 0..15  — bit planes: table[k, 4*t + w] holds bit t of the codes at
                positions w*32 .. w*32+31 of block k (LSB-first); XNOR-AND
                + popcount answers a 16-symbol rank with 64 popcounts;
  cols 16..31 — occurrence-checkpoint counts of the 16 symbols (int64
                layout: their low 32 bits, as uint32 bits);
  cols 32..47 — int64 layout only: the counts' high 32 bits.

Index arithmetic takes the layout's type, `DeviceIndex.idt`: int32 (rows of
128 bytes, genomes up to 2^31 positions, fwd+RC), or int64 for the
reference's whole-genome configuration (bwtint_t = uint64, common.h:6; the
fwd+RC text of GRCh37 is about 6.2e9 positions): rows of 192 bytes, still
one row read a rank query, and C, SA samples, positions and every interval
in int64.  The int64 layout is taken automatically at 2^31 positions, or on
request (`use_int64=True`).
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
    table: torch.Tensor       # int32 [num_blocks, 32 or 48] fused rows
    Carr: torch.Tensor        # idt [17] prefix counts
    sa_samples: torch.Tensor  # idt [num_sa] SA values every SA_INTERVAL
    length: int               # BWT length (host scalar: no device sync)
    sa0: int                  # sentinel row
    # When set (parallel.shard, tp > 1), the table range-sharded over the
    # tp members of a mesh row: tp_tables[t] holds blocks [t*n, (t+1)*n)
    # on member t's device and `table` is tp_tables[0].  A rank query takes
    # the owning shard's row (engine.rank._take_rows).  Checkpoint counts
    # are global cumulative ranks, so shards answer directly.
    tp_tables: tuple | None = None

    @property
    def num_blocks(self) -> int:
        return self.table.shape[0]

    @property
    def device(self) -> torch.device:
        return self.table.device

    @property
    def idt(self) -> torch.dtype:
        """Index arithmetic type: torch.int32, or torch.int64 for the
        whole-genome layout."""
        return self.Carr.dtype


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
    fed the very same index.  The table's width picks the layout: 32 words
    a row is the int32 layout, 48 the int64 one."""
    dev = resolve_device(device)
    table = np.array(table, dtype=np.int32)   # a writable copy
    if table.ndim != 2 or table.shape[1] not in (32, 48):
        raise ValueError("a device index table is [num_blocks, 32] (int32 "
                         "layout) or [num_blocks, 48] (int64 layout); got "
                         f"{table.shape}")
    idt = np.int64 if table.shape[1] == 48 else np.int32
    return DeviceIndex(
        table=torch.from_numpy(table).to(dev),
        Carr=torch.from_numpy(np.array(Carr, dtype=idt)).to(dev),
        sa_samples=torch.from_numpy(np.array(sa_samples, dtype=idt)).to(dev),
        length=int(length), sa0=int(sa0))


def from_fmindex(idx: FMIndex, use_int64: bool | None = None,
                 device=None) -> DeviceIndex:
    """Device layout for an FM-index.

    use_int64: the int64 whole-genome layout (None = automatic when the
    index has 2^31 positions or more)."""
    dev = resolve_device(device)
    if use_int64 is None:
        use_int64 = idx.length >= 2**31
    if not use_int64 and idx.length >= 2**31:
        raise ValueError("index has >= 2^31 positions: build with "
                         "use_int64=True")
    num_blocks = -(-idx.length // BLK)
    blocks = np.zeros((num_blocks, BLK), dtype=np.int8)
    blocks.reshape(-1)[:idx.length] = idx.bwt
    planes = build_planes(blocks)
    occ = idx.occ.astype(np.int64)
    if use_int64:
        table = np.concatenate(
            [planes, (occ & 0xFFFFFFFF).astype(np.uint32).view(np.int32),
             (occ >> 32).astype(np.int32)], axis=1)
    else:
        table = np.concatenate([planes, occ.astype(np.int32)], axis=1)
    return from_arrays(table, idx.Carr, idx.sa, idx.length, idx.sa0, dev)
