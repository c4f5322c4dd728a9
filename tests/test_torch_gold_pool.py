"""The port's host gold pool (align/gold_pool.py): threads where the workers
run the native multi-genome gold engine, `spawn`-context processes that
map the index and the seed table from one shared-memory segment where
they run the Python gold engine (`-P`, `-S`, no native library).  `.aln`
bytes against the JAX pipeline's and the gold engine's (zero tolerance),
what a spawned worker imports, and what a failing call leaves behind."""

import dataclasses
import glob
import multiprocessing as mp
import os
import signal
from concurrent.futures.process import BrokenProcessPool

import numpy as np
import pytest
import torch

from bwbble_tpu_torch import native as t_native
from bwbble_tpu_torch.align import gold_pool as GP
from bwbble_tpu_torch.align.params import AlnParams
from bwbble_tpu_torch.engine import device_index as TDI
from bwbble_tpu_torch.engine import pipeline as TPL
from bwbble_tpu_torch.engine.inexact import EngineConfig
from bwbble_tpu_torch.formats.aln import encode_alns
from test_torch_fixed import pipe_world  # noqa: F401
from test_torch_pipeline import native_lib  # noqa: F401
from test_torch_precalc import pipe_pre  # noqa: F401

torch.set_num_threads(1)


def _use_native(monkeypatch, lib) -> None:
    monkeypatch.setattr(t_native, "_native", lib)
    monkeypatch.setattr(t_native, "_tried", True)


def _my_segments() -> list:
    return glob.glob(os.path.join(GP.SHM_DIR,
                                  f"{GP.SHM_PREFIX}{os.getpid()}_*"))


def _leaves_nothing() -> None:
    assert mp.active_children() == []
    assert _my_segments() == []


def _align(w, params, precalc=None, queued=False, **kw):
    stats: dict = {}
    alns = TPL.align_reads_device(
        w["idx"], TDI.from_fmindex(w["idx"], device="cpu"), w["reads"],
        params, EngineConfig(cap=4096, acap=24), d_cap=32, stats=stats,
        precalc=precalc, seed_slots=2, queued=queued, qchunk=1,
        device="cpu", **kw)
    return b"".join(encode_alns(a) for a in alns), stats


@pytest.mark.parametrize("seeded,queued,n", [
    (True, False, 1), (True, False, 3), (True, True, 1), (True, True, 3),
    (False, False, 3), (False, True, 3)])
def test_pool_bytes_equal_jax_and_gold_and_kind_follows_engine(
        pipe_world, pipe_pre, native_lib, monkeypatch, seeded, queued, n):
    """align_reads_device over two batches, fixed or queued, with the gold
    pool up (the native library loaded): under `-P` its `n` workers are
    spawned processes and the `.aln` bytes equal the JAX pipeline's and
    the gold engine's with the same table; without `-P` the workers run
    the native engine on threads and the bytes equal the gold engine's."""
    _use_native(monkeypatch, native_lib)
    w = pipe_pre
    if seeded:
        params = dataclasses.replace(w["params"], n_threads=n)
        got, st = _align(w, params, w["table"], queued)
        assert got == w["gold"] == w["jax"]
        assert st["gold_pool"] == "processes"
    else:
        got, st = _align(w, AlnParams(max_diff=2, batch_size=128,
                                      n_threads=n), queued=queued)
        assert got == pipe_world["gold"]
        assert st["gold_pool"] == "threads"
    assert st["gold_workers"] == n and st["fallback_reads"] > 0
    assert 0.0 <= st["gold_pool_start_s"] < 120.0
    _leaves_nothing()


@pytest.mark.parametrize("mode", ["native", "seeded", "single", "no_native"])
def test_gold_fallback_many_kind_and_results(pipe_pre, native_lib,
                                             monkeypatch, mode):
    """gold_fallback_many on 3 workers equals the serial gold engine read
    for read, on threads only where the workers run the native engine."""
    w = pipe_pre
    _use_native(monkeypatch, None if mode == "no_native" else native_lib)
    params = AlnParams(max_diff=2, is_multiref=mode != "single")
    table = None
    if mode == "seeded":
        params, table = w["params"], w["table"]
    sel = list(range(0, w["reads"].count, 5))
    st: dict = {}
    got = TPL.gold_fallback_many(w["idx"], w["reads"], sel, params, table,
                                 3, st)
    want = TPL.gold_fallback_many(w["idx"], w["reads"], sel, params, table,
                                  1)
    assert got == want and sum(len(a) for a in want.values()) > 0
    kind = "threads" if mode == "native" else "processes"
    assert GP.pool_kind(params, table) == kind
    assert st["gold_pool"] == kind and st["gold_workers"] == 3
    _leaves_nothing()


def test_spawned_worker_imports_no_torch(pipe_pre):
    """A pool worker, started and holding the seed table, has imported
    the worker module and neither torch nor the device engine."""
    w = pipe_pre
    pool = GP.GoldPool(w["idx"], w["reads"], w["params"], w["table"], 1)
    try:
        assert pool.kind == "processes"
        mods = pool._ex.submit(
            eval, "sorted(__import__('sys').modules)").result(timeout=120)
        pool.submit([0, 1])
        assert len(pool.drain()) == 2
    finally:
        pool.terminate()
    assert "bwbble_tpu_torch.align.gold_pool" in mods
    assert "torch" not in mods
    assert not any(m.startswith("bwbble_tpu_torch.engine") for m in mods)
    _leaves_nothing()


@pytest.mark.parametrize("queued", [False, True])
def test_failing_call_leaves_no_worker_or_segment(pipe_pre, native_lib,
                                                  monkeypatch, queued):
    """A call that raises while the process pool holds work: no child
    process and no shared segment of the pool outlives it."""
    _use_native(monkeypatch, native_lib)
    w = pipe_pre
    submitted = []
    real_submit = GP.GoldPool.submit

    def submit(self, sel):
        submitted.append(len(sel))
        real_submit(self, sel)

    def boom(*a, **kw):
        assert mp.active_children() and _my_segments()
        raise RuntimeError("boom")

    monkeypatch.setattr(GP.GoldPool, "submit", submit)
    monkeypatch.setattr(TPL, "difficulty_scores" if queued else
                        "_lookup_seeds", boom)
    params = dataclasses.replace(w["params"], n_threads=3)
    with pytest.raises(RuntimeError, match="boom"):
        _align(w, params, w["table"], queued)
    assert queued or submitted
    _leaves_nothing()


def test_dead_worker_makes_the_call_raise(pipe_pre, native_lib,
                                          monkeypatch):
    """A worker killed while the pool holds work: the call raises (no
    carrying on on threads or in the caller) and leaves nothing behind."""
    _use_native(monkeypatch, native_lib)
    w = pipe_pre
    real_submit = GP.GoldPool.submit

    def submit(self, sel):
        real_submit(self, sel)
        pids = [p.pid for p in self._ex._processes.values()]
        if pids and not getattr(self, "_killed", False):
            self._killed = True
            os.kill(pids[0], signal.SIGKILL)

    monkeypatch.setattr(GP.GoldPool, "submit", submit)
    params = dataclasses.replace(w["params"], n_threads=2)
    with pytest.raises(BrokenProcessPool):
        _align(w, params, w["table"])
    _leaves_nothing()


def test_share_round_trips_the_arrays():
    """The segment holds each array at an aligned offset, as a worker's
    read-only views read it back."""
    rng = np.random.default_rng(0)
    arrays = dict(a=rng.integers(0, 255, 1001, dtype=np.uint8),
                  b=rng.integers(-2**40, 2**40, (37, 16), dtype=np.int64),
                  c=np.zeros(0, dtype=np.int64),
                  d=rng.integers(0, 9, 7, dtype=np.int32))
    shm, layout = GP._share(arrays)
    try:
        assert all(o % 64 == 0 for *_x, o in layout)
        buf = np.memmap(os.path.join(GP.SHM_DIR, shm.name.lstrip("/")),
                        dtype=np.uint8, mode="r")
        for key, dt, shape, o in layout:
            n = int(np.prod(shape, dtype=np.int64)) * np.dtype(dt).itemsize
            np.testing.assert_array_equal(
                buf[o:o + n].view(dt).reshape(shape), arrays[key])
        del buf
    finally:
        shm.close()
        shm.unlink()
    assert _my_segments() == []
