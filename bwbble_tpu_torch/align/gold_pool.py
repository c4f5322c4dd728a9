"""Host gold-engine workers that run beside the device search: a pool of
threads or of spawned processes.

Counterpart of the worker side of bwbble_tpu/engine/pipeline.py
(`_GoldPool`, `gold_fallback_many`, `_fb_worker`), whose pool forks.  A
process that holds a CUDA context must not fork, so the port takes the
pool's kind from what its workers run (`pool_kind`):

- the native multi-genome gold engine (no seed table, the native library
  loaded): threads of this process.  That engine releases the GIL inside
  its ctypes call and keeps its scratch thread-local, and the threads
  share the index as it is.
- the Python gold engine (`-P` seeding, a single genome `-S`, or no native
  library): processes of the `spawn` context.  That engine holds the GIL,
  so on threads it would starve the device pipeline of it.  The arrays it
  reads (the index's bwt, occ and Carr; the seed table's cnt, off, L and
  U) are written once into one shared-memory segment, which each worker
  maps read-only; a submission ships its reads' rows and gets their `Aln`
  lists back.

A worker's engine follows from what the caller passed: a process worker
runs the Python engine, and marks the native library absent in its own
process, so it never loads it.  Nothing falls
back: a process pool that cannot start, or a worker that dies, makes
`drain` raise, and `drain` and `terminate` leave no worker and no segment
behind.

This module imports neither torch nor anything that imports it: it is
what a spawned worker imports, and a worker never touches the card.
"""

from __future__ import annotations

import os
import secrets
import time
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from multiprocessing import get_context, shared_memory

import numpy as np

from bwbble_tpu_torch import native
from bwbble_tpu_torch.align.params import AlnParams
from bwbble_tpu_torch.align.pipeline import align_read_gold
from bwbble_tpu_torch.align.precalc import PrecalcTable
from bwbble_tpu_torch.formats.fastq import Reads
from bwbble_tpu_torch.index.fmindex import FMIndex

SHM_DIR = "/dev/shm"          # where POSIX shared memory lives on Linux
SHM_PREFIX = "bwbble_gold_"   # the name of every segment a pool makes
READY_TIMEOUT_S = 300.0       # a worker not up by then breaks the pool
CHUNK = 8                     # most reads one submission to a process ships


def pool_kind(params: AlnParams, precalc) -> str:
    """"threads" where the workers run the native multi-genome gold engine
    (no seed table, multi-genome, the native library loaded), else
    "processes" (the Python gold engine)."""
    nat = native.get_native()
    on_native = (precalc is None and params.is_multiref and nat is not None
                 and getattr(nat, "_has_gold", False))
    return "threads" if on_native else "processes"


class GoldPool:
    """`n_workers` gold-engine workers of `pool_kind(params, precalc)`.
    `submit` queues reads of `reads` by index; `drain` returns every
    submitted read's `Aln` list and closes the pool; `terminate` closes it
    at once (the exception path; a no-op after `drain`).  `start_s`: the
    seconds from the pool's construction until every worker was ready
    (read once `drain` has returned); `shared_bytes`: the size of the
    processes' shared segment."""

    def __init__(self, idx: FMIndex, reads: Reads, params: AlnParams,
                 precalc, n_workers: int = 1):
        t0 = time.time()
        self.kind = pool_kind(params, precalc)
        self.workers = max(1, int(n_workers))
        self.submitted = 0
        self.start_s = 0.0
        self._t0 = t0
        self._idx, self._reads = idx, reads
        self._params, self._precalc = params, precalc
        self._futs: list = []
        self._pings: list = []
        self._shm = None
        self.shared_bytes = 0
        if self.kind == "threads":
            idx.bit_planes()              # materialize the shared rank
            idx.fused_planes()            # planes before any worker
            self._ex = ThreadPoolExecutor(self.workers)
            self.start_s = time.time() - t0
            return
        arrays = dict(bwt=idx.bwt, occ=idx.occ, Carr=idx.Carr)
        if precalc is not None:
            arrays.update(cnt=precalc.cnt, off=precalc.off, L=precalc.L,
                          U=precalc.U)
        self._shm, layout = _share(arrays)
        self.shared_bytes = self._shm.size
        try:
            ctx = get_context("spawn")
            # one ping a worker, each waiting for all: every worker has
            # started once the pings are back
            barrier = ctx.Barrier(self.workers)
            self._ex = ProcessPoolExecutor(
                self.workers, mp_context=ctx, initializer=_init,
                initargs=(self._shm.name, layout, int(idx.length),
                          int(idx.sa0), params, precalc is not None,
                          barrier))
            self._pings = [self._ex.submit(_ready)
                           for _ in range(self.workers)]
        except BaseException:
            self.terminate()
            raise

    def submit(self, sel) -> None:
        sel = [int(i) for i in sel]
        if not sel:
            return
        self.submitted += len(sel)
        r = self._reads
        if self.kind == "threads":
            for i in sel:
                self._futs.append(([i], self._ex.submit(
                    _align_here, self._idx, r.seq[i:i + 1], r.rc[i:i + 1],
                    r.lengths[i:i + 1], self._params, self._precalc)))
            return
        step = max(1, min(CHUNK, -(-len(sel) // self.workers)))
        for s in range(0, len(sel), step):
            ids = sel[s:s + step]
            self._futs.append((ids, self._ex.submit(
                _align_rows, r.seq[ids], r.rc[ids], r.lengths[ids])))

    def drain(self) -> dict[int, list]:
        out: dict[int, list] = {}
        for ids, f in self._futs:
            for i, alns in zip(ids, f.result()):
                out[i] = alns
        self._futs = []
        if self._pings:
            self.start_s = max(f.result() for f in self._pings) - self._t0
        self._ex.shutdown(wait=True)
        self._ex = None
        self._unlink()
        return out

    def terminate(self) -> None:
        ex = getattr(self, "_ex", None)
        if ex is not None:
            if self.kind == "processes":
                # a worker deep in a hard read would hold shutdown for it
                for p in list((getattr(ex, "_processes", None)
                               or {}).values()):
                    p.terminate()
            ex.shutdown(wait=True, cancel_futures=True)
            self._ex = None
        self._unlink()

    def stats(self) -> dict:
        return dict(gold_pool=self.kind, gold_workers=self.workers,
                    gold_pool_start_s=round(self.start_s, 3),
                    gold_pool_shared_bytes=self.shared_bytes)

    def _unlink(self) -> None:
        if self._shm is not None:
            self._shm.close()
            self._shm.unlink()
            self._shm = None


NO_POOL = dict(gold_pool=None, gold_workers=0, gold_pool_start_s=0.0,
               gold_pool_shared_bytes=0)


def _share(arrays: dict):
    """One shared-memory segment holding `arrays`, each at a 64-byte
    aligned offset: (the segment, its layout [(key, dtype, shape,
    offset)])."""
    layout, off = [], 0
    for key, a in arrays.items():
        a = np.ascontiguousarray(a)
        layout.append((key, a.dtype.str, a.shape, off))
        off += -(-a.nbytes // 64) * 64
    size = max(off, 64)
    st = os.statvfs(SHM_DIR)
    if st.f_bavail * st.f_frsize < size:
        # a write past the free room of the mount would kill the process
        # with SIGBUS
        raise RuntimeError(
            f"gold pool: {SHM_DIR} has {st.f_bavail * st.f_frsize} bytes "
            f"free, its shared arrays need {size}")
    shm = shared_memory.SharedMemory(
        name=f"{SHM_PREFIX}{os.getpid()}_{secrets.token_hex(6)}",
        create=True, size=size)
    try:
        for (key, dt, shape, o), a in zip(layout, arrays.values()):
            view = np.ndarray(shape, dtype=dt, buffer=shm.buf, offset=o)
            view[...] = a
            del view
    except BaseException:
        shm.close()
        shm.unlink()
        raise
    return shm, layout


# ---------------------------------------------------------------- workers

_W: dict = {}


def _init(name: str, layout: list, length: int, sa0: int,
          params: AlnParams, seeded: bool, barrier) -> None:
    """A process worker's state: read-only views of the parent's segment
    (mapped as a file, so the worker neither registers nor closes it).
    The worker runs the Python gold engine, so it marks the native library
    as absent in its own process and never loads it."""
    native._native, native._tried = None, True
    buf = np.memmap(os.path.join(SHM_DIR, name), dtype=np.uint8, mode="r")
    a = {key: buf[o:o + int(np.prod(shape, dtype=np.int64))
                  * np.dtype(dt).itemsize].view(dt).reshape(shape)
         for key, dt, shape, o in layout}
    idx = FMIndex(length=length, sa0=sa0, bwt=a["bwt"], Carr=a["Carr"],
                  occ=a["occ"], sa=np.zeros(0, dtype=np.int64))
    table = (PrecalcTable(cnt=a["cnt"], off=a["off"], L=a["L"], U=a["U"])
             if seeded else None)
    _W.update(idx=idx, params=params, precalc=table, barrier=barrier)


def _ready() -> float:
    _W["barrier"].wait(READY_TIMEOUT_S)
    return time.time()


def _align_rows(seq: np.ndarray, rc: np.ndarray,
                lengths: np.ndarray) -> list:
    """The Python gold engine on a submission's reads, in a worker."""
    return _align_here(_W["idx"], seq, rc, lengths, _W["params"],
                       _W["precalc"])


def _align_here(idx, seq, rc, lengths, params, precalc) -> list:
    return [align_read_gold(idx, seq[j], rc[j], int(lengths[j]), params,
                            precalc=precalc)
            for j in range(len(lengths))]
