"""Build, bind and launch the hand-written CUDA kernels of the port.

Counterpart of bwbble_tpu/engine/kernel.py: `ring_search` takes the place of
`run_loop_resident_queued` driving `_resident_kernel` in ring mode, and
`fixed_search` that of `run_loop_resident` driving it in fixed-batch mode,
each for the multi-genome and the single-genome (`-S`) alphabet.  Given
seeds (`-P`), the same two entries take the place of `run_loop` driving
`_kernel_body`, the JAX package's kernel for seeded roots (NROOT > 1).  On
the int64 whole-genome index layout `fixed_search` takes that layout's
instantiations (the JAX package runs that layout in fixed batches only, and
so does the port).  On an index range-sharded over the tp cards of a mesh
row (parallel/shard.py, `DeviceIndex.tp_tables`), `fixed_search` takes the
sharded instantiations, which read each rank row from the shard that owns
its block, on the launching card or on a peer card over NVLink
(`enable_peer`); a ring launch takes no shards, as a mesh runs fixed
batches only.  The kernel source is csrc/ring_search.cu (one template, ten
instantiations); the plain PyTorch versions are
engine/inexact.py:ring_search_plain and fixed_search_plain.  The same
source holds the D and D_seed bounds of a chunk in one launch on the same
rank code (every layout the fixed search takes): `dbound_1to1` for a single
genome, `dbound_mg` for a multi-genome at a list capacity K; their plain
versions are engine/dbound.py:calc_d_1to1_chunk_plain and
calc_d_chunk_plain, which their chunk entries take on the CPU.

Build: at first use, `nvcc` compiles the source for sm_90a into a shared
library with a plain C interface under `build/` at the repository root,
named by a content hash of the source so a stale build is never loaded; the
library is bound with ctypes.  A build or load failure raises.  Nothing here
runs when the module is imported.

Shared memory: a block is one lane (one warp), which holds its read's
small state there (`lane_smem_bytes`); `block_smem_bytes` raises
ValueError, before any launch, for a configuration past the card's 227 KB
a block.  Timing: given a `timer`, the C launch itself records two CUDA
events on the current stream right before and after the kernel launch, with
no Python between them, so what they time is the kernel's own run.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np
import torch

from bwbble_tpu_torch.align.params import AlnParams
from bwbble_tpu_torch.engine.device_index import DeviceIndex
from bwbble_tpu_torch.engine.inexact import (NMETA, EngineConfig,
                                             RingStatics, alloc_outputs,
                                             result_dict, ring_statics)

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(os.path.dirname(_HERE), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build")

# launches per kernel entry, incremented where a kernel is launched and
# nowhere else (a run can show that its path went through the kernels); a
# launch counts under one key only: its entry, then `_seeded` for a seeded
# launch, `_tp` for one on a range-sharded table, `_i64` for one on the
# int64 index layout
LAUNCHES = {"ring_search": 0, "fixed_search": 0, "ring_search_seeded": 0,
            "fixed_search_seeded": 0, "fixed_search_i64": 0,
            "fixed_search_seeded_i64": 0, "fixed_search_tp": 0,
            "fixed_search_seeded_tp": 0, "fixed_search_tp_i64": 0,
            "fixed_search_seeded_tp_i64": 0, "dbound_1to1": 0,
            "dbound_1to1_i64": 0, "dbound_1to1_tp": 0,
            "dbound_1to1_tp_i64": 0, "dbound_mg": 0, "dbound_mg_i64": 0,
            "dbound_mg_tp": 0, "dbound_mg_tp_i64": 0}

# shards a table may have (csrc/ring_search.cu RS_TP_MAX)
MAX_TP = 8

# the largest list capacity `dbound_mg` takes (csrc/ring_search.cu DBM_KMAX)
DB_KMAX = 1024

# dynamic shared memory a block may have on an H100 (227 KB)
SMEM_MAX = 232448

# frames a read may have for a lane to keep their parents in shared memory,
# on the int32 layout (csrc/ring_search.cu RS_PAR_MAX)
PAR_MAX = 2048

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    return cand if os.path.exists(cand) else "nvcc"


def build(name: str = "ring_search") -> str:
    """Compile csrc/<name>.cu into build/lib<name>_<hash>.so (if not there
    yet) and return the library's path; the compiler's report (registers,
    stack, spills) is kept beside it as <library>.log."""
    src = os.path.join(CSRC, name + ".cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    out = os.path.join(BUILD_DIR, f"lib{name}_{digest}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "--expt-relaxed-constexpr", "-shared", "-Xcompiler",
           "-fPIC", "-Xptxas", "-v", "-o", tmp, src]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{r.stdout}\n{r.stderr}")
    with open(out + ".log", "w") as f:
        f.write(r.stderr)
    os.replace(tmp, out)
    return out


def _bind_ring_search(lib: ctypes.CDLL) -> None:
    vp = ctypes.c_void_p
    lib.ring_search_launch.argtypes = ([vp] + [ctypes.c_int] * 4
                                       + [vp, ctypes.c_int, ctypes.c_longlong]
                                       + [vp] * 16)
    lib.ring_search_launch.restype = ctypes.c_int
    lib.ring_search_enable_peer.argtypes = [ctypes.c_int] * 2
    lib.ring_search_enable_peer.restype = ctypes.c_int
    lib.ring_search_error_string.argtypes = [ctypes.c_int]
    lib.ring_search_error_string.restype = ctypes.c_char_p
    lib.ring_search_lane_smem.argtypes = [ctypes.c_int] * 6
    lib.ring_search_lane_smem.restype = ctypes.c_longlong
    lib.ring_search_row_words.argtypes = [ctypes.c_int] * 2
    lib.ring_search_row_words.restype = ctypes.c_int
    lib.ring_search_occupancy.argtypes = [ctypes.c_int] * 4 + [
        ctypes.c_longlong]
    lib.ring_search_occupancy.restype = ctypes.c_int
    lib.ring_search_num_params.argtypes = []
    lib.ring_search_num_params.restype = ctypes.c_int
    lib.ring_search_num_meta.argtypes = []
    lib.ring_search_num_meta.restype = ctypes.c_int
    lib.dbound_1to1_launch.argtypes = ([ctypes.c_int, vp, ctypes.c_int]
                                       + [ctypes.c_longlong] * 2 + [vp] * 3
                                       + [ctypes.c_int] * 3 + [vp] * 4)
    lib.dbound_1to1_launch.restype = ctypes.c_int
    lib.dbound_mg_launch.argtypes = ([ctypes.c_int, vp, ctypes.c_int]
                                     + [ctypes.c_longlong] * 2 + [vp] * 3
                                     + [ctypes.c_int] * 4 + [vp] * 4)
    lib.dbound_mg_launch.restype = ctypes.c_int


def _load(name: str = "ring_search", bind=_bind_ring_search) -> ctypes.CDLL:
    """The library built from csrc/<name>.cu, loaded once and bound by
    `bind(lib)`, which sets its entry points' argument and result types."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(build(name))
            bind(lib)
            _libs[name] = lib
        return lib


def count_launch(launches: dict, entry: str, rc: int) -> None:
    """Raise for a launch that returned CUDA error `rc`, else add one to
    `launches[entry]`."""
    if rc != 0:
        raise RuntimeError(f"{entry}: launch failed with CUDA error {rc}")
    launches[entry] += 1


def launch_events() -> tuple:
    """Two timing events for `ring_search_launch` to record in C right
    around its kernel launch.  torch creates an event's CUDA handle at its
    first record, so each is recorded once on the current stream here, which
    the launch's own record then replaces."""
    ev = tuple(torch.cuda.Event(enable_timing=True) for _ in range(2))
    for e in ev:
        e.record()
        if not e.cuda_event:
            raise RuntimeError("a CUDA event has no handle after its record")
    return ev


def _check(t: torch.Tensor, name: str, dtype, ndim: int, dev,
           what: str = "search kernel") -> None:
    if not (t.is_cuda and t.device == dev and t.dtype == dtype
            and t.dim() == ndim and t.is_contiguous()):
        raise ValueError(
            f"{what}: `{name}` must be a contiguous {ndim}-d {dtype} "
            f"CUDA tensor on {dev}; got {t.dtype} {tuple(t.shape)} on "
            f"{t.device}")


def param_block(params: AlnParams, S, Q: int, Lmax: int, length: int,
                lanes: int) -> np.ndarray:
    """The kernel's RSParams fields, in order, as int32 (the length split
    into its low 32 bits, wrapped to int32, and its high 32 bits)."""
    p = params
    lo = ((int(length) + 2**31) % 2**32) - 2**31
    return np.array(
        [p.mm_score, p.gapo_score, p.gape_score, p.max_diff, p.max_gapo,
         p.max_gape, p.seed_length, p.max_diff_seed, p.max_best,
         p.no_indel_length, min(int(p.max_entries), 2**31 - 1),
         S.NB, S.NFRAME, S.ACAP, S.XC, S.PATHCAP, S.max_iters,
         Q, Lmax, S.DS, lo, lanes, S.PW, S.NROOT, S.PK,
         int(length) >> 32], dtype=np.int32)


def lane_smem_bytes(S: RingStatics) -> int:
    """Shared-memory bytes of one lane (csrc/ring_search.cu LaneSmem):
    C [17], D [(Lmax + 1) * 2], D_seed [DS * 2] and the two exact-completion
    lists [2, XC, 2] in the index's type, the NB bucket heads (int32), the
    read's codes (int8) and, on the int32 layout when a read has at most
    PAR_MAX frames, their parent nodes [NFRAME] (int32), each rounded up to
    16 bytes."""
    it = 8 if S.x64 else 4

    def up(n: int) -> int:
        return (n + 15) // 16 * 16
    npar = S.NFRAME if not S.x64 and S.NFRAME <= PAR_MAX else 0
    return (up(17 * it) + up((S.Lmax + 1) * 2 * it) + up(S.DS * 2 * it)
            + up(4 * S.XC * it) + up(S.NB * 4) + up(S.Lmax) + up(4 * npar))


def block_smem_bytes(S: RingStatics) -> int:
    """Shared bytes a block (one lane) of a launch asks for; raises
    ValueError when they exceed what a block may have."""
    lane = lane_smem_bytes(S)
    if lane > SMEM_MAX:
        raise ValueError(
            f"search kernel: a lane needs {lane} bytes of shared memory "
            f"(NB={S.NB}, Lmax={S.Lmax}, DS={S.DS}, XC={S.XC}, "
            f"{'int64' if S.x64 else 'int32'}); a block has {SMEM_MAX}")
    return lane


def resident_lanes(S: RingStatics, sharded: bool = False) -> int:
    """Lanes of a launch of this configuration (`sharded`: on a sharded
    table) that one SM holds at once: the blocks an SM takes
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor, at the launch's shared
    memory a block) times the lanes a block."""
    n = _load().ring_search_occupancy(int(S.multiref), int(S.fixed),
                                      int(S.x64), int(sharded),
                                      block_smem_bytes(S))
    if n < 0:
        raise RuntimeError(f"occupancy query failed with CUDA error {-n}")
    return n


def shard_args(didx: DeviceIndex) -> tuple[np.ndarray, int, int]:
    """The table as `ring_search_launch` takes it: (MAX_TP pointers as
    uint64, the shards' count tp, their rows nloc); tp = 1 and the whole
    table for an unsharded index.  Raises ValueError for more than MAX_TP
    shards, shards of unequal rows or of another type, width or layout
    than the index's, or too few rows for the blocks the length needs (a
    rank reads blocks up to (length - 2) // 128)."""
    shards = didx.tp_tables or (didx.table,)
    tp = len(shards)
    if tp > MAX_TP:
        raise ValueError(f"search kernel: a table of {tp} shards; at most "
                         f"{MAX_TP} (one a card of a mesh row)")
    width = 48 if didx.idt == torch.int64 else 32
    nloc = shards[0].shape[0] if shards[0].dim() == 2 else 0
    for t, sh in enumerate(shards):
        if not (sh.dtype == torch.int32 and sh.dim() == 2
                and sh.shape == (nloc, width) and sh.is_contiguous()):
            raise ValueError(
                f"search kernel: table shard {t} must be a contiguous "
                f"[{nloc}, {width}] int32 tensor like shard 0; got "
                f"{sh.dtype} {tuple(sh.shape)}")
    if nloc < 1 or (int(didx.length) - 2) // 128 >= nloc * tp:
        raise ValueError(f"search kernel: {tp} shard(s) of {nloc} rows do "
                         f"not hold the blocks of an index of length "
                         f"{int(didx.length)}")
    ptrs = np.zeros(MAX_TP, dtype=np.uint64)
    ptrs[:tp] = [sh.data_ptr() for sh in shards]
    return ptrs, tp, nloc


def _ordinal(d: torch.device) -> int:
    return torch.cuda.current_device() if d.index is None else d.index


def enable_peer(dev: torch.device, peer: torch.device) -> None:
    """Let kernels launched on card `dev` read the memory of card `peer`
    over NVLink (cudaDeviceEnablePeerAccess; a pair that PyTorch or an
    earlier call already enabled is taken as it is); nothing for one card.
    Raises RuntimeError with the CUDA error where `dev` cannot reach
    `peer`: a shard is never copied to the launching card in its place."""
    a, b = _ordinal(torch.device(dev)), _ordinal(torch.device(peer))
    if a == b:
        return
    lib = _load()
    rc = lib.ring_search_enable_peer(a, b)
    if rc != 0:
        raise RuntimeError(
            f"peer access from cuda:{a} to cuda:{b} refused: CUDA error "
            f"{rc} ({lib.ring_search_error_string(rc).decode()}); a table "
            f"sharded over these cards cannot be searched from cuda:{a}")


def _launch(entry: str, didx: DeviceIndex, rc_all: torch.Tensor,
            lengths_all: torch.Tensor, D_all: torch.Tensor,
            Ds_all: torch.Tensor, params: AlnParams, cfg: EngineConfig,
            lanes: int | None, seeds, timer=None, defer: bool = False):
    """Check the arguments, allocate outputs and scratch, launch one
    instantiation of the kernel (`lanes` None: fixed mode, one lane per
    read; `seeds` None or (seed_L, seed_U, seed_cnt)) and count the launch.
    Given a `timer`, sets `timer.events` to two CUDA events that
    `ring_search_launch` records on the current stream right before and
    after the kernel launch.  On a range-sharded index it launches on the
    card of shard 0, where the search state lives, and reads the other
    shards there by peer access.  Returns (q_alns, q_meta, q_paths, arena).
    Does not synchronise.  `defer`: do everything but the launch and
    return `go`, whose call launches and returns those outputs: the
    launches of a mesh's members then follow each other with no host work
    between them."""
    fixed = lanes is None
    if not fixed and didx.tp_tables is not None:
        raise ValueError(f"{entry}: a ring launch takes no sharded table "
                         "(a mesh runs fixed batches only)")
    ptrs, tp, nloc = shard_args(didx)
    idt = didx.idt
    x64 = idt == torch.int64
    if rc_all.dim() != 2 or (seeds is not None and seeds[0].dim() != 2):
        raise ValueError(f"{entry}: rc must be [Q, Lmax] and seed_L [Q, S]")
    Q, Lmax = rc_all.shape
    nseed = 0 if seeds is None else seeds[0].shape[1]
    S = ring_statics(params, cfg, Lmax, Ds_all.shape[1], fixed=fixed,
                     seed_slots=nseed, x64=x64)
    lanes = Q if fixed else max(1, min(int(lanes), Q))
    smem = block_smem_bytes(S)
    dev = didx.table.device
    if dev.type != "cuda":
        raise ValueError(f"{entry} launches a CUDA kernel: the index lives "
                         f"on {dev}")
    for t, sh in enumerate(didx.tp_tables or ()):
        if not sh.is_cuda:
            raise ValueError(f"{entry}: table shard {t} lives on "
                             f"{sh.device}, not on a CUDA device")
        enable_peer(dev, sh.device)
    _check(didx.table, "table", torch.int32, 2, dev)
    _check(didx.Carr, "Carr", idt, 1, dev)
    _check(rc_all, "rc", torch.int8, 2, dev)
    _check(lengths_all, "lengths", torch.int32, 1, dev)
    _check(D_all, "D", idt, 3, dev)
    _check(Ds_all, "Ds", idt, 3, dev)
    if seeds is not None:
        sL, sU, scnt = seeds
        _check(sL, "seed_L", idt, 2, dev)
        _check(sU, "seed_U", idt, 2, dev)
        _check(scnt, "seed_cnt", torch.int32, 1, dev)
        if (sL.shape[0] != Q or nseed < 1 or sU.shape != sL.shape
                or scnt.shape[0] != Q):
            raise ValueError(f"{entry}: inconsistent seed shapes")
        entry += "_seeded"
    if tp > 1:
        entry += "_tp"
    if (didx.Carr.shape[0] != 17
            or lengths_all.shape[0] != Q
            or tuple(D_all.shape) != (Q, Lmax + 1, 2)
            or D_all.shape[0] != Ds_all.shape[0] or Ds_all.shape[2] != 2):
        raise ValueError(f"{entry}: inconsistent input shapes")
    if int(didx.length) < 2 or Q < 1:
        raise ValueError(f"{entry}: empty index or read set")
    if x64:
        entry += "_i64"
    lib = _load()
    hp = param_block(params, S, Q, Lmax, int(didx.length), lanes)
    if (hp.size != lib.ring_search_num_params()
            or S.ROWW != lib.ring_search_row_words(int(S.multiref),
                                                   int(x64))
            or NMETA != lib.ring_search_num_meta()
            or smem != lib.ring_search_lane_smem(
                S.NB, S.Lmax, S.DS, S.XC, int(x64), S.NFRAME)):
        raise RuntimeError(f"{entry}: parameter block, frame-row width, "
                           "result columns or shared-memory layout out of "
                           "date")
    sp = [x.data_ptr() for x in seeds] if seeds is not None else [None] * 3

    with torch.cuda.device(dev):
        _load_on_card(lib, dev, int(S.multiref), int(fixed), int(x64),
                      int(tp > 1), smem)
        q_alns, q_meta, q_paths = alloc_outputs(Q, S, dev)
        arena = torch.empty((lanes, S.NFRAME, S.ROWW), dtype=torch.int32,
                            device=dev)
        counter = torch.zeros((1,), dtype=torch.int32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        ev = None if timer is None else launch_events()
        evp = [None] * 2 if ev is None else [e.cuda_event for e in ev]

    def go() -> tuple:
        with torch.cuda.device(dev):
            rc = lib.ring_search_launch(
                hp.ctypes.data, hp.size, int(S.multiref), int(fixed),
                int(x64), ptrs.ctypes.data, tp, nloc, didx.Carr.data_ptr(),
                rc_all.data_ptr(), lengths_all.data_ptr(), D_all.data_ptr(),
                Ds_all.data_ptr(), *sp, arena.data_ptr(),
                counter.data_ptr(), q_alns.data_ptr(), q_meta.data_ptr(),
                q_paths.data_ptr(), stream, *evp)
        if ev is not None:
            timer.events = ev
        count_launch(LAUNCHES, entry, rc)
        # the scratch tensors stay referenced by the caching allocator's
        # stream ordering: later allocations on this stream cannot reuse
        # them before the kernel has finished
        return q_alns, q_meta, q_paths, arena

    return go if defer else go()


_ON_CARD: set = set()      # (card, instantiation) pairs already loaded


def _load_on_card(lib, dev: torch.device, multiref: int, fixed: int,
                  x64: int, sharded: int, smem: int) -> None:
    """Have the card load an instantiation before its first launch there
    (CUDA loads a kernel lazily, at its first use on a card, which would
    otherwise sit between the launches of a mesh's members): one occupancy
    query a card and instantiation, which raises on a CUDA error."""
    key = (_ordinal(dev), multiref, fixed, x64, sharded)
    if key in _ON_CARD:
        return
    n = lib.ring_search_occupancy(multiref, fixed, x64, sharded, smem)
    if n < 0:
        raise RuntimeError(f"occupancy query failed with CUDA error {-n}")
    _ON_CARD.add(key)


def ring_search(didx: DeviceIndex, rc_all: torch.Tensor,
                lengths_all: torch.Tensor, D_all: torch.Tensor,
                Ds_all: torch.Tensor, params: AlnParams, cfg: EngineConfig,
                lanes: int, seeds=None, timer=None) -> dict:
    """Launch the ring-queue search on CUDA tensors: `lanes` lanes (at most
    one per read) stream through the reads; `seeds` None, or (seed_L [Q, S],
    seed_U [Q, S], seed_cnt [Q]) int32 for a seeded search with NROOT = S;
    `timer` None, or an object whose `events` the launch sets (`_launch`).
    Returns the per-read result dict (engine/inexact.py:result_dict) of
    device tensors.  Does not synchronise.  Raises for anything the kernel
    does not take — there is no fallback to the plain version."""
    q_alns, q_meta, q_paths, _arena = _launch(
        "ring_search", didx, rc_all, lengths_all, D_all, Ds_all, params,
        cfg, lanes, seeds, timer)
    return result_dict(q_alns, q_meta, q_paths)


def fixed_search(didx: DeviceIndex, rc: torch.Tensor, lengths: torch.Tensor,
                 D: torch.Tensor, Ds: torch.Tensor, params: AlnParams,
                 cfg: EngineConfig, seeds=None, timer=None,
                 defer: bool = False):
    """Launch the fixed-batch search on CUDA tensors: lane b runs read b
    and nothing else, so there is a lane, and an arena column, for exactly
    the reads given; `seeds` and `timer` as for `ring_search`.  On the int64 index
    layout D, Ds and the seed intervals are int64, and so are the reported
    L/U.  Returns the per-read
    result dict in read order plus `arena`, the launch's frame rows
    [B, NFRAME, ROWW] (its scratch, valid once the launch has finished).
    Does not synchronise.  Raises for anything the kernel does not take —
    there is no fallback to the plain version.  `defer`: return a callable
    that launches and returns the result dict (`_launch`)."""
    def results(q_alns, q_meta, q_paths, arena) -> dict:
        # result_dict computes from the outputs: only after the launch
        return dict(result_dict(q_alns, q_meta, q_paths), arena=arena)

    if defer:
        go = _launch("fixed_search", didx, rc, lengths, D, Ds, params, cfg,
                     None, seeds, timer, defer=True)
        return lambda: results(*go())
    return results(*_launch("fixed_search", didx, rc, lengths, D, Ds,
                            params, cfg, None, seeds, timer))


def dbound_outputs(B: int, Lmax: int, seed_len: int, idt, dev) -> tuple:
    """A D-bound kernel's outputs, which it writes whole: D [B, Lmax + 1,
    2] and Ds [B, max(seed_len, 1) + 1, 2] in the index's type, the
    overflow flags [B] bool."""
    return (torch.empty((B, Lmax + 1, 2), dtype=idt, device=dev),
            torch.empty((B, max(seed_len, 1) + 1, 2), dtype=idt, device=dev),
            torch.empty((B,), dtype=torch.bool, device=dev))


def dbound_call(lib: ctypes.CDLL, didx: DeviceIndex, seq: torch.Tensor,
                lengths: torch.Tensor, seed_len: int, D: torch.Tensor,
                Ds: torch.Tensor, ov: torch.Tensor, stream,
                K: int | None = None) -> int:
    """`dbound_1to1_launch` of `lib` on these tensors, or `dbound_mg_launch`
    at list capacity K where K is given (`dbound_1to1` and `dbound_mg`
    check them first); returns its CUDA error, 0 on success."""
    ptrs, tp, nloc = shard_args(didx)
    B, Lmax = seq.shape
    head = (int(didx.idt == torch.int64), ptrs.ctypes.data, tp, nloc,
            int(didx.length), didx.Carr.data_ptr(), seq.data_ptr(),
            lengths.data_ptr(), B, Lmax, int(seed_len))
    tail = (D.data_ptr(), Ds.data_ptr(), ov.data_ptr(), stream)
    if K is None:
        return lib.dbound_1to1_launch(*head, *tail)
    return lib.dbound_mg_launch(*head, int(K), *tail)


def _dbound(what: str, didx: DeviceIndex, seq: torch.Tensor,
            lengths: torch.Tensor, seed_len: int,
            K: int | None = None) -> tuple:
    """Check a D-bound launch's arguments, allocate its outputs, launch
    (`dbound_call`) and count it under `what` with its layout's suffix."""
    dev = didx.table.device
    if dev.type != "cuda":
        raise ValueError(f"{what} launches a CUDA kernel: the index lives "
                         f"on {dev}")
    _, tp, _ = shard_args(didx)
    idt = didx.idt
    _check(didx.Carr, "Carr", idt, 1, dev, what)
    _check(seq, "seq", torch.int8, 2, dev, what)
    _check(lengths, "lengths", torch.int32, 1, dev, what)
    B, Lmax = seq.shape
    if (didx.Carr.shape[0] != 17 or lengths.shape[0] != B or B < 1
            or Lmax < 1 or int(didx.length) < 2):
        raise ValueError(f"{what}: inconsistent or empty input shapes")
    for t, sh in enumerate(didx.tp_tables or ()):
        if not sh.is_cuda:
            raise ValueError(f"{what}: table shard {t} lives on "
                             f"{sh.device}, not on a CUDA device")
        enable_peer(dev, sh.device)
    entry = what + ("_tp" if tp > 1 else "") + (
        "_i64" if idt == torch.int64 else "")
    lib = _load()
    with torch.cuda.device(dev):
        D, Ds, ov = dbound_outputs(B, Lmax, seed_len, idt, dev)
        rc = dbound_call(lib, didx, seq, lengths, seed_len, D, Ds, ov,
                         torch.cuda.current_stream(dev).cuda_stream, K)
    count_launch(LAUNCHES, entry, rc)
    return D, Ds, ov


def dbound_1to1(didx: DeviceIndex, seq: torch.Tensor, lengths: torch.Tensor,
                seed_len: int) -> tuple:
    """Launch the single-genome D-bound kernel on a chunk of reads (seq
    [B, Lmax] int8 nt4 codes, lengths [B] int32, on the index's card):
    returns (D, Ds, overflow) as engine/dbound.py:calc_d_1to1_chunk does,
    the overflow flags all false.  On a range-sharded index it launches on
    the card of shard 0 and reads the other shards by peer access.  Does
    not synchronise.  Raises for anything the kernel does not take, and
    for a launch that returns a CUDA error — there is no fallback to the
    plain version."""
    return _dbound("dbound_1to1", didx, seq, lengths, seed_len)


def dbound_mg(didx: DeviceIndex, seq: torch.Tensor, lengths: torch.Tensor,
              seed_len: int, K: int) -> tuple:
    """Launch the multi-genome D-bound kernel on a chunk of reads at list
    capacity K (1 to DB_KMAX; seq and lengths as for `dbound_1to1`):
    returns (D, Ds, overflow) as engine/dbound.py:calc_d_chunk does.  A
    range-sharded index, the synchronisation, the refusals and the absence
    of a fallback as for `dbound_1to1`; a K out of range raises
    ValueError, and a launch the card cannot hold (a block's shared memory,
    which grows with K and Lmax, past 227 KB) a RuntimeError."""
    if not 1 <= int(K) <= DB_KMAX:
        raise ValueError(f"dbound_mg: list capacity K = {K}; it takes 1 to "
                         f"{DB_KMAX}")
    return _dbound("dbound_mg", didx, seq, lengths, seed_len, int(K))
