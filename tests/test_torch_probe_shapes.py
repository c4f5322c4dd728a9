"""The launch shapes of the row gather (K6, csrc/probes.cu) on the CPU:
`benchmarks/kernels.py:gather_shape` computes grid, rows a step, the tile
or run of rows a warp or ring takes, ring slots and shared bytes, and the C
side's gather_shape mirrors it (the chip run holds the two equal on the
card).  `gather_moves` follows the kernel's loops: every output row must be
written exactly once, and a ring row stored from the slot its copy landed
in.  The card's SMs and the blocks an SM holds come from an occupancy query
on the card; here they range over the H100's 132 SMs at several
occupancies, and a card of one SM holding one block."""

import re

import numpy as np
import pytest

from bwbble_tpu_torch.benchmarks import kernels as K
from bwbble_tpu_torch.engine.kernel import CSRC, SMEM_MAX

VARIANTS = [("direct", 1, 8), ("direct", 8, 8), ("ring", 1, 8),
            ("ring", 1, 32)]
OCCUPANCY = [(132, 16), (132, 12), (132, 3), (1, 1)]


def gather_moves(shape: K.GatherShape, n: int, mode: str
                 ) -> tuple[np.ndarray, np.ndarray]:
    """What csrc/probes.cu's gather loops move, as (rows, where): each
    output row written, in the order the warps write them, warp by warp;
    `where` is the warp for `direct`, and for `ring` the slot of its ring
    the row is stored from."""
    rows, where = [], []
    warps = shape.grid * K.GATHER_WARPS
    if mode == "direct":
        unroll = shape.step // 4
        for w in range(warps):
            for t0 in range(w * shape.tile, n, warps * shape.tile):
                m = min(shape.tile, n - t0)
                for s in range(0, m, shape.step):
                    for u in range(unroll):
                        for g in range(4):
                            r = s + 4 * u + g
                            if r < m:
                                rows.append(t0 + r)
                                where.append(w)
        return np.array(rows, dtype=np.int64), np.array(where)
    for w in range(warps):
        s0 = w * shape.tile
        cnt = min(shape.tile, n - s0)
        for st in range(0, cnt, shape.step):
            k = min(shape.step, cnt - st)
            rows.extend(range(s0 + st, s0 + st + k))
            where.extend(range(st % shape.slots, st % shape.slots + k))
    return np.array(rows, dtype=np.int64), np.array(where)


@pytest.mark.parametrize("n", ["nbuf", 1000, 16383, 16384, 65536])
@pytest.mark.parametrize("mode,unroll,nbuf", VARIANTS)
def test_gather_shape_covers_every_row_once(mode, unroll, nbuf, n):
    n = nbuf if n == "nbuf" else n
    for sms, bps in OCCUPANCY:
        s = K.gather_shape(n, mode, unroll, nbuf, sms, bps)
        assert 1 <= s.grid <= sms * bps and s.block == K.BLOCK
        assert 0 <= s.smem <= SMEM_MAX
        rows, where = gather_moves(s, n, mode)
        np.testing.assert_array_equal(np.sort(rows), np.arange(n))
        warps = s.grid * K.GATHER_WARPS
        if mode == "direct":
            assert s.step == 4 * unroll and s.slots == 0 and s.smem == 0
            assert s.tile % s.step == 0 and s.step <= s.tile <= 32
            tiles = -(-n // s.tile)
            # below 32 rows a tile, every tile has its own warp
            assert s.tile == 32 or tiles <= warps
            # tile t goes to warp t mod the warps (grid stride)
            np.testing.assert_array_equal(where, (rows // s.tile) % warps)
        else:
            assert s.step == nbuf // K.RING_STAGES and s.slots == nbuf
            assert s.tile >= nbuf and s.tile % s.step == 0
            # each row leaves from the slot its copy went to, q % nbuf
            np.testing.assert_array_equal(where, (rows % s.tile) % nbuf)
            slots, bars = K.ring_layout(nbuf)
            assert all(o % 128 == 0 for o in slots)
            assert all(o % 8 == 0 for o in bars)
            assert slots[-1] + nbuf * K.ROW_BYTES == bars[0]
            assert bars[-1] + 8 * nbuf == s.smem


def test_gather_shape_constants_match_the_kernel_source():
    """The constants gather_shape uses are the C side's."""
    with open(f"{CSRC}/probes.cu") as f:
        src = f.read()

    def define(name):
        return re.search(rf"#define {name} (\S+)", src).group(1)
    assert int(define("PR_BLOCK")) == K.BLOCK
    assert "#define GATHER_WARPS (PR_BLOCK / PR_WARP)" in src
    assert int(define("ROW_BYTES")) == K.ROW_BYTES
    assert int(define("RING_STAGES")) == K.RING_STAGES
    assert "GATHER_WARPS * nbuf * (ROW_BYTES + 8)" in src
    # ring_layout's offsets
    assert "smem_u32(ring_smem) + wib * NBUF * ROW_BYTES;" in src
    assert "+ GATHER_WARPS * NBUF * ROW_BYTES + wib * NBUF * 8;" in src
