"""The probe kernels' plain versions (bwbble_tpu_torch/benchmarks/kernels.py)
against the JAX package's Pallas probes (benchmarks/dma_probe.py,
gather_pallas_probe.py, gather_bench.py) on the same numpy-seeded inputs.
All comparisons are of int32 words: the tolerance is zero.

The Pallas kernels run in interpret mode on the CPU.  The probe modules are
not edited for that: each test replaces the module's `pl` name with a
namespace whose `pallas_call` adds `interpret=pltpu.InterpretParams()` (and
drops `compiler_params`, which interpret mode does not take, for
dma_probe), and shrinks the module's globals N, B and RQ with monkeypatch.
The loops of gather_pallas_probe.py run eagerly (`jax.jit` and
`lax.fori_loop` replaced the same way) for two iterations, on tables and
start indices drawn from a seeded numpy generator in the order the probe
draws them.
"""

import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from benchmarks import dma_probe as JDP
from benchmarks import gather_bench as JGB
from benchmarks import gather_pallas_probe as JGP

from bwbble_tpu_torch.benchmarks import dma_probe, gather_bench
from bwbble_tpu_torch.benchmarks import gather_pallas_probe as gpp
from bwbble_tpu_torch.benchmarks import kernels as K

torch.set_num_threads(1)


class _Over:
    """A module's name seen through, with some attributes replaced."""

    def __init__(self, base, **over):
        self._base = base
        self.__dict__.update(over)

    def __getattr__(self, name):
        return getattr(self._base, name)


def _interpret_pl(drop_compiler_params=False):
    def pallas_call(*args, **kw):
        if drop_compiler_params:
            kw.pop("compiler_params", None)
        kw["interpret"] = pltpu.InterpretParams()
        return pl.pallas_call(*args, **kw)
    return _Over(pl, pallas_call=pallas_call)


def _wrap32(x):
    return ((np.asarray(x, dtype=np.int64) + 2**31) % 2**32 - 2**31)


# ------------------------------------------------------------------- K4

@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("compute", [False, True])
def test_dma_wave_equals_jax_probe(monkeypatch, seed, compute):
    n, B0, K_ = 4096, 8, 3
    monkeypatch.setattr(JDP, "N", n)
    monkeypatch.setattr(JDP, "pl", _interpret_pl(drop_compiler_params=True))
    rng = np.random.default_rng(seed)
    tbl = rng.integers(0, 1 << 30, (n, 128)).astype(np.int32)
    idx0 = rng.integers(0, n, (8, B0)).astype(np.int32)
    # the first wave's sums wrap past 2^31 and go negative, so the update
    # needs floor modulo
    first = _wrap32(tbl[idx0[0], :8].astype(np.int64).sum(axis=1))
    assert (first < 0).any()
    ref = np.asarray(JDP._make(B0, K_, compute)(jnp.asarray(idx0),
                                                jnp.asarray(tbl)))
    got = K.dma_wave(torch.from_numpy(idx0), torch.from_numpy(tbl), K_,
                     compute).numpy()
    np.testing.assert_array_equal(got, ref)
    assert (got[0] != idx0[0]).any() and (got[1:] == idx0[1:]).all()


# ------------------------------------------------------------------- K5

@pytest.mark.parametrize("variant", ["take", "gatherT", "rowmajor"])
def test_digest_consume_equals_jax_consumers(monkeypatch, variant):
    """The consumers at B = 128 on rows laid out by the JAX probe's own
    gathers, against the port's gather + digest."""
    n, B = 4096, 128
    monkeypatch.setattr(JGP, "B", B)
    monkeypatch.setattr(JGP, "pl", _interpret_pl())
    rng = np.random.default_rng(7)
    table = rng.integers(0, 1 << 30, (n, 32)).astype(np.int32)
    k = rng.integers(0, n, (JGP.RQ, B)).astype(np.int32)
    jt, jk = jnp.asarray(table), jnp.asarray(k)
    if variant == "take":
        ref = JGP.consume(JGP.v_take(jt, jk))
    elif variant == "gatherT":
        ref = JGP.consume(JGP.v_gatherT(jt, jk))
    else:
        ref = JGP.consume_rowmajor(JGP.v_take_rowmajor(jt, jk))
    tt, tk = torch.from_numpy(table), torch.from_numpy(k)
    x = gpp.gather_rows(variant, tt, tk)
    got = K.digest_consume(x, gpp.VARIANTS[variant][2], JGP.RQ, B)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def _eager_reference(monkeypatch, n, B, iters, seed):
    """Patch gather_pallas_probe to run its loops eagerly for `iters`
    iterations on seeded inputs; returns the record of inputs drawn and
    loop outputs."""
    rec = {"ins": [], "outs": []}
    rs = np.random.RandomState(seed)

    def randint(lo, hi, shape, dtype):
        a = rs.randint(lo, hi, shape, dtype)
        rec["ins"].append(a)
        return a

    def fori_loop(lo, hi, body, init):
        k = init
        for i in range(iters):
            k = body(i, k)
        rec["outs"].append(np.asarray(k))
        return k

    monkeypatch.setattr(JGP, "N", n)
    monkeypatch.setattr(JGP, "B", B)
    monkeypatch.setattr(JGP, "R", JGP.RQ * B)
    monkeypatch.setattr(JGP, "pl", _interpret_pl())
    monkeypatch.setattr(JGP, "lax", _Over(lax, fori_loop=fori_loop))
    monkeypatch.setattr(JGP, "jax", _Over(jax, jit=lambda f: f))
    monkeypatch.setattr(JGP, "np", _Over(
        np, random=types.SimpleNamespace(randint=randint)))
    return rec


_RUNS = {"take": lambda: JGP.run("take", JGP.v_take),
         "gatherT": lambda: JGP.run("gatherT", JGP.v_gatherT),
         "rowmajor": lambda: JGP.run_rowmajor(),
         "pad128": lambda: JGP.run_pad128(),
         "pad128g3": lambda: JGP.run_pad128_grid()}


@pytest.mark.parametrize("variant", sorted(_RUNS))
def test_gather_loop_equals_jax_probe(monkeypatch, variant):
    """Two iterations of each RQ = 6 loop (the four layouts) from the
    probe's own seeded table and k0: the indices after them are equal.  B =
    512 gives the blocked layout two blocks of 256 lanes."""
    n, B, iters = 4096, 512, 2
    rec = _eager_reference(monkeypatch, n, B, iters, seed=11)
    _RUNS[variant]()
    table, k0 = rec["ins"][:2]
    ref = rec["outs"][-1]
    got = gpp.loop(variant, torch.from_numpy(table), torch.from_numpy(k0),
                   iters).numpy()
    np.testing.assert_array_equal(got, ref)
    assert (got != k0).any()


@pytest.mark.parametrize("rq", [4, 2])
def test_gather_loop_at_other_stream_counts(monkeypatch, rq):
    """C4: the JAX probe's run_rq adds d[:6] to k [RQ, B] and dies at
    RQ != 6; the port's loop adds d[:RQ], checked against a numpy model."""
    n, B = 4096, 512
    _eager_reference(monkeypatch, n, B, 1, seed=3)
    with pytest.raises(TypeError, match="broadcast"):
        JGP.run_rq(rq)
    rng = np.random.default_rng(rq)
    table = rng.integers(0, 1 << 30, (n, 32)).astype(np.int32)
    k = rng.integers(0, n, (rq, B)).astype(np.int32)
    got = gpp.loop(f"take_rq{rq}", torch.from_numpy(table),
                   torch.from_numpy(k), 2).numpy()
    for _ in range(2):
        rows = table[k.reshape(-1)].reshape(rq, B, 32).astype(np.int64)
        d = _wrap32(rows[:, :, :8].sum(axis=0).T)            # [8, B]
        k = (_wrap32(k.astype(np.int64) + d[:rq]) % n).astype(np.int32)
    np.testing.assert_array_equal(got, k)


# ------------------------------------------------------------------- K6

@pytest.mark.parametrize("mode,unroll,nbuf", [("direct", 1, 8),
                                              ("direct", 8, 8),
                                              ("ring", 1, 8),
                                              ("ring", 1, 32)])
def test_row_gather_equals_jax_gathers(monkeypatch, mode, unroll, nbuf):
    monkeypatch.setattr(JGB, "pl", _interpret_pl())
    rng = np.random.default_rng(5)
    table = rng.integers(-2**31, 2**31 - 1, (1000, 32)).astype(np.int32)
    idx = rng.integers(0, 1000, 64).astype(np.int32)
    if mode == "direct":
        ref = JGB.gather_vmem(jnp.asarray(table), jnp.asarray(idx), unroll)
    else:
        ref = JGB.gather_hbm(jnp.asarray(table), jnp.asarray(idx), nbuf)
    got = K.row_gather(torch.from_numpy(table), torch.from_numpy(idx), mode,
                       unroll, nbuf)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(got.numpy(), table[idx])


def test_ring_gather_refuses_fewer_rows_than_copies():
    """The TPU ring starts NBUF copies before its loop, so it needs n >=
    NBUF; the port keeps the precondition and raises on it."""
    table = torch.zeros((100, 32), dtype=torch.int32)
    idx = torch.arange(8, dtype=torch.int32)
    assert K.row_gather(table, idx, "ring", nbuf=8).shape == (8, 32)
    for fn in (K.row_gather, K.row_gather_plain):
        with pytest.raises(ValueError, match="at least 32"):
            fn(table, idx, "ring", nbuf=32)
        with pytest.raises(ValueError, match="at least 8"):
            fn(table, idx[:7], "ring", nbuf=8)


def test_wrappers_refuse_indices_outside_the_table():
    """An index outside the table raises IndexError, never a read past it:
    on the CPU through index_select, on the card through the wrappers'
    own check (held there by chip_smoke.py's probes phase)."""
    table = torch.zeros((100, 32), dtype=torch.int32)
    tbl = torch.zeros((100, 128), dtype=torch.int32)
    for bad in (100, -1):
        idx = torch.arange(8, dtype=torch.int32)
        idx[3] = bad
        with pytest.raises(IndexError):
            K.row_gather(table, idx)
        with pytest.raises(IndexError):
            K.row_gather(table, idx, "ring", nbuf=8)
        idx0 = torch.zeros((8, 4), dtype=torch.int32)
        idx0[0, 1] = bad
        with pytest.raises(IndexError):
            K.dma_wave(idx0, tbl, 2)
        with pytest.raises(IndexError, match="outside the table"):
            K._check_index("row_gather", idx, 100)


# ------------------------------------------------------- the entry points

def test_probe_entry_points_run_on_the_cpu_when_asked():
    """The three probes end to end at small sizes with device="cpu": the
    plain versions run and nothing is timed."""
    r = dma_probe.run(8, 3, device="cpu", n=2048)
    assert [x["variant"] for x in r] == ["wave", "compute"]
    assert all(x["out"].shape == (8, 8) and "ms" not in x for x in r)
    for v in gpp.VARIANTS:
        x = gpp.run(v, device="cpu", iters=2, n=2048, b=256)
        assert x["k"].shape == (gpp.VARIANTS[v][0], 256)
    rows = gather_bench.run(device="cpu", nblk=500, ns=(64,))
    assert [x["variant"] for x in rows] == [
        "take", "direct u1", "direct u8", "ring b8", "ring b32"]
    assert all(x["equal"] for x in rows)
    assert K.LAUNCHES == {"dma_wave": 0, "digest_consume": 0,
                          "row_gather": 0}
