"""Wrappers of the probe kernels (csrc/probes.cu) and their plain PyTorch
versions.

- `dma_wave` replaces benchmarks/dma_probe.py:_make (K4): B0 lanes run K
  dependent row waves over a [N, 128] int32 table;
- `digest_consume` replaces the consumers of benchmarks/
  gather_pallas_probe.py (K5): the [8, B] digest of gathered rows in one of
  `LAYOUTS`;
- `row_gather` replaces benchmarks/gather_bench.py:gather_vmem and
  gather_hbm (K6): out[i] = table[idx[i]], `direct` (16-byte loads in a
  persistent grid) or through a `ring` of bulk row copies; its launch shape
  is `gather_shape`, which csrc/probes.cu mirrors;
- `launch_floor` launches an empty kernel of a given grid: it replaces no
  TPU kernel and measures the least time a launch of that shape takes.

A wrapper given CPU tensors runs the plain version (`*_plain`, which takes
CPU tensors only); given CUDA tensors it launches the kernel or raises.  It
never falls back.  On the card `dma_wave` and `row_gather` check that their
indices lie in the table (on the CPU `index_select` does), unless the
caller passes `check_index=False` for indices known to lie in it: the
probes' timed calls, since the check reads a flag back to the host.  The library is built at first use by
engine/kernel.py:build("probes") into `build/`; nothing here runs when the
module is imported.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from bwbble_tpu_torch.engine.kernel import _load as _load_lib
from bwbble_tpu_torch.engine.kernel import count_launch
from bwbble_tpu_torch.engine.rank import popcount32

# launches per kernel, incremented where a kernel is launched and nowhere
# else
LAUNCHES = {"dma_wave": 0, "digest_consume": 0, "row_gather": 0}

# layouts of the rows digest_consume reads (csrc/probes.cu LAYOUT_*):
# lane-major [RQ * 32, B], stream-major [RQ * B, 32], stream-major padded
# [RQ * B, 128], blocked [RQ, B, 128] (a block per 256 lanes)
LAYOUTS = ("lane_major", "row_major", "row_major_128", "blocked_128")
BLOCKED_LANES = 256
DIGEST_W = 8
ROW_WORDS = 128          # dma_wave's rows: 512 bytes
GATHER_WORDS = 32        # row_gather's rows: 128 bytes
BLOCK = 128              # threads a block of every probe kernel but one
GATHER_WARPS = BLOCK // 32   # row_gather: warps, or rings, a block
ROW_BYTES = 4 * GATHER_WORDS
RING_STAGES = 2          # bulk stores a turn of a ring


def _bind(lib: ctypes.CDLL) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.dma_wave_launch.argtypes = [vp, vp, vp, ci, ci, ci, ci, vp]
    lib.digest_consume_launch.argtypes = [vp, vp, ci, ci, ci, vp]
    lib.row_gather_launch.argtypes = [vp, vp, vp, ci, ci, ci, ci, vp]
    lib.row_gather_shape.argtypes = [ci, ci, ci, ci,
                                     ctypes.POINTER(ctypes.c_int)]
    lib.probe_floor_launch.argtypes = [ci, ci, vp]
    for f in (lib.dma_wave_launch, lib.digest_consume_launch,
              lib.row_gather_launch, lib.row_gather_shape,
              lib.probe_floor_launch):
        f.restype = ci


def _load() -> ctypes.CDLL:
    return _load_lib("probes", _bind)


def _on_cpu(name: str, *ts: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU; raises unless they all lie
    on one CUDA device, int32 and contiguous."""
    if all(t.device.type == "cpu" for t in ts):
        return True
    dev = ts[0].device
    for t in ts:
        if not (t.is_cuda and t.device == dev and t.dtype == torch.int32
                and t.is_contiguous()):
            raise ValueError(
                f"{name}: every argument must be a contiguous int32 CUDA "
                f"tensor on {dev}; got {t.dtype} {tuple(t.shape)} on "
                f"{t.device}")
    return False


def _cpu_only(name: str, *ts: torch.Tensor) -> None:
    for t in ts:
        if t.device.type != "cpu":
            raise ValueError(f"{name} takes CPU tensors; got one on "
                             f"{t.device}")


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 with two's-complement wrap (jnp's int32 arithmetic)."""
    return (((x + 2**31) % 2**32) - 2**31).to(torch.int32)


def _launched(name: str, rc: int) -> None:
    count_launch(LAUNCHES, name, rc)


def _check_index(name: str, idx: torch.Tensor, n: int) -> None:
    """Raise IndexError unless every index lies in [0, n)."""
    if bool(((idx < 0) | (idx >= n)).any()):
        raise IndexError(f"{name}: an index lies outside the table's {n} "
                         "rows")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# ------------------------------------------------------------------- K4

def _check_wave(idx0: torch.Tensor, tbl: torch.Tensor, K: int) -> None:
    if (idx0.dim() != 2 or idx0.shape[0] != 8 or idx0.shape[1] < 1
            or tbl.dim() != 2 or tbl.shape[1] != ROW_WORDS
            or tbl.shape[0] < 1 or int(K) < 0):
        raise ValueError("dma_wave takes idx0 [8, B0], a table [N, 128] "
                         "and K >= 0")


def wave_grid(B0: int) -> tuple[int, int]:
    """(blocks, threads a block) of a dma_wave launch of B0 lanes, a warp
    a lane (csrc/probes.cu dma_wave_launch)."""
    return (B0 * 32 + BLOCK - 1) // BLOCK, BLOCK


def dma_wave_plain(idx0: torch.Tensor, tbl: torch.Tensor, K: int,
                   compute: bool = False) -> torch.Tensor:
    """The plain version of dma_wave, on CPU tensors."""
    _cpu_only("dma_wave_plain", idx0, tbl)
    _check_wave(idx0, tbl, K)
    N = tbl.shape[0]
    idx = idx0[0].to(torch.int64)
    # bit tt of code j, j < 8, as [1, 8, 1, 4, 1]
    jbits = torch.tensor([[(j >> tt) & 1 for tt in range(4)]
                          for j in range(8)], dtype=torch.bool
                         ).reshape(1, 8, 1, 4, 1)
    for _ in range(int(K)):
        rows = tbl.index_select(0, idx)                 # [B0, 128]
        if compute:
            # word rep*16 + 4*tt + w as x[b, rep, tt, w]; per code j the AND
            # over tt of the word or its complement, popcounts summed
            x = rows[:, :32].reshape(-1, 1, 2, 4, 4)
            sel = torch.where(jbits, x, ~x)             # [B0, 8, 2, 4, 4]
            m = sel[:, :, :, 0] & sel[:, :, :, 1] & sel[:, :, :, 2] \
                & sel[:, :, :, 3]
            s = popcount32(m).to(torch.int64).sum(dim=(1, 2, 3))
        else:
            s = _wrap32(rows[:, :8].to(torch.int64).sum(dim=1)).to(
                torch.int64)
        idx = _wrap32(idx + s).to(torch.int64) % N
    out = idx0.clone()
    out[0] = idx.to(torch.int32)
    return out


def dma_wave(idx0: torch.Tensor, tbl: torch.Tensor, K: int,
             compute: bool = False, check_index: bool = True
             ) -> torch.Tensor:
    """K dependent waves of B0 lanes: each wave fetches row tbl[idx[0, b]]
    of every lane b and sets idx[0, b] = (idx[0, b] + s) mod N (int32
    wrapping sum, floor modulo), s the sum of the row's first 8 words, or
    with `compute` the popcount digest of its first 32
    (benchmarks/dma_probe.py).  idx0 int32 [8, B0], tbl int32 [N, 128];
    returns [8, B0]: row 0 the final indices, rows 1..7 idx0's.  idx0[0]
    must lie in [0, N)."""
    _check_wave(idx0, tbl, K)
    if _on_cpu("dma_wave", idx0, tbl):
        return dma_wave_plain(idx0, tbl, K, compute)
    if check_index:
        _check_index("dma_wave", idx0[0], tbl.shape[0])
    out = torch.empty_like(idx0)
    rc = _load().dma_wave_launch(
        idx0.data_ptr(), tbl.data_ptr(), out.data_ptr(), idx0.shape[1],
        int(K), tbl.shape[0], int(bool(compute)), _stream(idx0))
    _launched("dma_wave", rc)
    return out


# ------------------------------------------------------------------- K5

def digest_view(x: torch.Tensor, layout: str, RQ: int, B: int
                 ) -> torch.Tensor:
    """The digest words of every gathered row as a [RQ, 8, B] view of x
    (checks x's shape against the layout): summed over its first axis, the
    digest."""
    shapes = {"lane_major": (RQ * 32, B), "row_major": (RQ * B, 32),
              "row_major_128": (RQ * B, 128),
              "blocked_128": (RQ, B, 128)}
    if layout not in shapes:
        raise ValueError(f"layout must be one of {LAYOUTS}, not {layout!r}")
    if tuple(x.shape) != shapes[layout] or RQ < 1 or B < 1:
        raise ValueError(f"digest_consume: a {layout} input is "
                         f"{shapes[layout]}; got {tuple(x.shape)}")
    if layout == "blocked_128" and B % BLOCKED_LANES:
        raise ValueError(f"blocked_128 takes a multiple of {BLOCKED_LANES} "
                         "lanes")
    if layout == "lane_major":
        return x.reshape(RQ, 32, B)[:, :DIGEST_W, :]
    w = 32 if layout == "row_major" else 128
    return x.reshape(RQ, B, w)[:, :, :DIGEST_W].transpose(1, 2)


def digest_grid(layout: str, B: int) -> tuple[int, int]:
    """(blocks, threads a block) of a digest_consume launch over B lanes
    (csrc/probes.cu digest_consume_launch)."""
    if layout == "blocked_128":
        return B // BLOCKED_LANES, BLOCKED_LANES
    return (DIGEST_W * B + BLOCK - 1) // BLOCK, BLOCK


def digest_consume_plain(x: torch.Tensor, layout: str, RQ: int, B: int
                         ) -> torch.Tensor:
    """The plain version of digest_consume, on CPU tensors."""
    _cpu_only("digest_consume_plain", x)
    rows = digest_view(x, layout, RQ, B)
    return _wrap32(rows.to(torch.int64).sum(dim=0)).contiguous()


def digest_consume(x: torch.Tensor, layout: str, RQ: int, B: int
                   ) -> torch.Tensor:
    """d[w, b] = sum over q < RQ of word w of row (q, b), w < 8 (int32,
    wrapping), from rows in `layout`; returns int32 [8, B]."""
    digest_view(x, layout, RQ, B)
    if _on_cpu("digest_consume", x):
        return digest_consume_plain(x, layout, RQ, B)
    d = torch.empty((DIGEST_W, B), dtype=torch.int32, device=x.device)
    rc = _load().digest_consume_launch(x.data_ptr(), d.data_ptr(), int(RQ),
                                       int(B), LAYOUTS.index(layout),
                                       _stream(x))
    _launched("digest_consume", rc)
    return d


# ------------------------------------------------------------------- K6

def _check_gather(table: torch.Tensor, idx: torch.Tensor, mode: str,
                  unroll: int, nbuf: int) -> None:
    if (table.dim() != 2 or table.shape[1] != GATHER_WORDS
            or idx.dim() != 1 or idx.shape[0] < 1):
        raise ValueError("row_gather takes a table [NBLK, 32] and indices "
                         "[n], n >= 1")
    if mode == "direct":
        if unroll not in (1, 8):
            raise ValueError("direct gathers unroll 1 or 8 rows a step")
    elif mode == "ring":
        if nbuf not in (8, 32):
            raise ValueError("the ring holds 8 or 32 row copies")
        if idx.shape[0] < nbuf:
            # the TPU kernel starts nbuf copies before its loop
            raise ValueError(f"a ring of {nbuf} copies needs at least "
                             f"{nbuf} rows, got {idx.shape[0]}")
    else:
        raise ValueError(f"mode must be 'direct' or 'ring', not {mode!r}")


class GatherShape(NamedTuple):
    """A row_gather launch: `grid` blocks of `block` threads; direct: `step`
    rows a warp a step, `tile` rows a warp takes at a time; ring: `step`
    rows a bulk store, `tile` rows a ring, `slots` slots a ring; `smem`
    shared bytes a block."""
    grid: int
    block: int
    step: int
    tile: int
    slots: int
    smem: int


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def gather_shape(n: int, mode: str, unroll: int, nbuf: int, sms: int,
                 blocks_per_sm: int) -> GatherShape:
    """The launch shape of row_gather over n rows on a card of `sms` SMs
    that holds `blocks_per_sm` blocks of the variant each (csrc/probes.cu
    gather_shape mirrors this).  The grid is persistent: at most the blocks
    the card holds at once, and no more than the rows need.  direct: the
    tile is the least of step, 2 step, ... 32 rows for which every tile
    has its own warp (else 32), so that few rows still spread over every
    warp; ring: a ring takes the most rows one of the card's rings must
    take, at least nbuf, in whole stages of nbuf / RING_STAGES rows."""
    blocks_max = sms * blocks_per_sm
    warps_max = blocks_max * GATHER_WARPS
    if mode == "direct":
        step = 4 * unroll
        tile = step
        while tile < 32 and _ceil(n, tile) > warps_max:
            tile *= 2
        grid = min(blocks_max, _ceil(_ceil(n, tile), GATHER_WARPS))
        return GatherShape(grid, BLOCK, step, tile, 0, 0)
    step = nbuf // RING_STAGES
    run = _ceil(max(_ceil(n, warps_max), nbuf), step) * step
    grid = _ceil(_ceil(n, run), GATHER_WARPS)
    return GatherShape(grid, BLOCK, step, run, nbuf,
                       GATHER_WARPS * nbuf * (ROW_BYTES + 8))


def ring_layout(nbuf: int) -> tuple[list[int], list[int]]:
    """Byte offsets in a block's shared memory of each ring's first slot
    and first mbarrier: every ring's slots, then every ring's barriers
    (csrc/probes.cu gather_ring_kernel's `slots` and `bars`)."""
    slots = [w * nbuf * ROW_BYTES for w in range(GATHER_WARPS)]
    bars = [GATHER_WARPS * nbuf * ROW_BYTES + w * nbuf * 8
            for w in range(GATHER_WARPS)]
    return slots, bars


def gather_shape_on_card(n: int, mode: str = "direct", unroll: int = 1,
                         nbuf: int = 8) -> tuple[GatherShape, int, int]:
    """The shape row_gather_launch takes on the current CUDA device, from
    the C side, with the SMs and the blocks an SM holds it used."""
    out = (ctypes.c_int * 8)()
    rc = _load().row_gather_shape(int(n), 0 if mode == "direct" else 1,
                                  int(unroll), int(nbuf), out)
    if rc != 0:
        raise RuntimeError(f"row_gather_shape failed with {rc}")
    return GatherShape(*out[:6]), out[6], out[7]


def row_gather_plain(table: torch.Tensor, idx: torch.Tensor,
                     mode: str = "direct", unroll: int = 1, nbuf: int = 8
                     ) -> torch.Tensor:
    """The plain version of row_gather, on CPU tensors."""
    _cpu_only("row_gather_plain", table, idx)
    _check_gather(table, idx, mode, unroll, nbuf)
    return table.index_select(0, idx.to(torch.int64))


def row_gather(table: torch.Tensor, idx: torch.Tensor, mode: str = "direct",
               unroll: int = 1, nbuf: int = 8, check_index: bool = True
               ) -> torch.Tensor:
    """out[i] = table[idx[i]]: table int32 [NBLK, 32], idx int32 [n] in
    [0, NBLK); `direct` moves `unroll` rows a warp per step, `ring` keeps
    `nbuf` row copies in flight (n >= nbuf)."""
    _check_gather(table, idx, mode, unroll, nbuf)
    if _on_cpu("row_gather", table, idx):
        return row_gather_plain(table, idx, mode, unroll, nbuf)
    if check_index:
        _check_index("row_gather", idx, table.shape[0])
    n = idx.shape[0]
    out = torch.empty((n, GATHER_WORDS), dtype=torch.int32,
                      device=table.device)
    rc = _load().row_gather_launch(
        table.data_ptr(), idx.data_ptr(), out.data_ptr(), n,
        0 if mode == "direct" else 1, int(unroll), int(nbuf),
        _stream(table))
    _launched("row_gather", rc)
    return out


def launch_floor(grid: int, block: int, device) -> None:
    """Launch the empty kernel on `grid` blocks of `block` threads on the
    current stream of CUDA `device` (no TPU kernel: the launch floor)."""
    rc = _load().probe_floor_launch(
        int(grid), int(block),
        torch.cuda.current_stream(torch.device(device)).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"probe_floor_launch failed with CUDA error {rc}")


def time_calls(fn, args_list: list, n: int) -> float:
    """Milliseconds a call of `fn` takes on the card: one warm-up call on
    the last argument tuple, then `n` calls over the others in turn (warm
    and timed inputs differ), between two CUDA events."""
    fn(*args_list[-1])
    torch.cuda.synchronize()
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    timed = args_list[:-1] or args_list
    ev0.record()
    for i in range(n):
        fn(*timed[i % len(timed)])
    ev1.record()
    torch.cuda.synchronize()
    return ev0.elapsed_time(ev1) / n


def time_graph(fn, args_list: list, n: int) -> float:
    """Milliseconds a call of `fn` takes on the card without the host's
    dispatch: after a warm-up call on the last argument tuple, `n` calls
    over the others in turn are captured in one CUDA graph, and one replay
    of the graph is timed between two CUDA events, over `n`.  `fn` must not
    synchronise with the host."""
    fn(*args_list[-1])
    torch.cuda.synchronize()
    timed = args_list[:-1] or args_list
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(*timed[0])
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(n):
            fn(*timed[i % len(timed)])
    graph.replay()
    torch.cuda.synchronize()
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    ev0.record()
    graph.replay()
    ev1.record()
    torch.cuda.synchronize()
    return ev0.elapsed_time(ev1) / n
