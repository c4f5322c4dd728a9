"""The port's device meshes (parallel/shard.py) on CPU "devices", against the
port's one-device engines and the JAX package's sharded engines on its 8
virtual CPU devices (tests/conftest.py).  dp only splits the batch, and
tp's masked-and-summed rank rows are exact (one shard owns each block), so
every comparison is of integers and bytes: the tolerance is zero.

As in tests/test_torch_fixed.py, the JAX fixed batch runs in lockstep, so
its frame budget counts the waves of the whole launch, where the port's
counts each read's own pops: every read the JAX batch finishes, the port
finishes with equal fields; the port's overflow set is a subset of the JAX
one."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bwbble_tpu.align.params import AlnParams as JParams
from bwbble_tpu.engine.device_index import from_fmindex as j_from_fmindex
from bwbble_tpu.engine.inexact import EngineConfig as JConfig
from bwbble_tpu.engine.pipeline import align_reads_device as j_align_device
from bwbble_tpu.formats.aln import encode_alns as j_encode
from bwbble_tpu.parallel import make_mesh as j_make_mesh
from bwbble_tpu.parallel import sharded_align_step as j_align_step
from bwbble_tpu.parallel import sharded_inexact_search as j_sharded_search

from bwbble_tpu_torch import native as t_native
from bwbble_tpu_torch.align.params import AlnParams
from bwbble_tpu_torch.engine import inexact as t_inexact
from bwbble_tpu_torch.engine import kernel
from bwbble_tpu_torch.engine.device_index import from_fmindex
from bwbble_tpu_torch.engine.inexact import EngineConfig, inexact_search
from bwbble_tpu_torch.engine.dpass import chunk_bounds
from bwbble_tpu_torch.engine.pipeline import align_reads_device
from bwbble_tpu_torch.engine.rank import _take_rows, rank_all_dfs
from bwbble_tpu_torch.formats.aln import encode_alns
from bwbble_tpu_torch.formats.fastq import read_fastq
from bwbble_tpu_torch.index import FMIndex
from bwbble_tpu_torch.parallel import (make_mesh, sharded_align_step,
                                       sharded_inexact_search)
from bwbble_tpu_torch.parallel import shard
from bwbble_tpu_torch.parallel.shard import sharded_calc_d_chunk
from test_torch_fixed import PER_READ, as_numpy, both_indexes
from test_torch_pipeline import no_native  # noqa: F401

torch.set_num_threads(1)

CPU8 = [torch.device("cpu")] * 8
CAP, ACAP, KX, MAX_ITERS = 16384, 16, 8, 50_000
CFG = EngineConfig(cap=CAP, acap=ACAP, kx=KX, max_iters=MAX_ITERS)
MESHES = [(2, 1), (1, 2), (2, 2)]


@pytest.fixture(scope="module")
def world(small_world):
    """The JAX tests' small world: the JAX index, the port's index over the
    same table, and the first 16 reads with their D bounds."""
    jdx, tdx = both_indexes(small_world["idx"])
    reads = small_world["reads"]
    n = 16
    seq = np.asarray(reads.seq[:n], dtype=np.int8)
    rc = np.asarray(reads.rc[:n], dtype=np.int8)
    ln = reads.lengths[:n].astype(np.int32)
    p = AlnParams(max_diff=2)
    D, Ds, _ = chunk_bounds(tdx, seq, ln, p, 16)
    one = inexact_search(tdx, rc, ln, D, Ds, p, CFG, device="cpu")
    return dict(jdx=jdx, tdx=tdx, seq=seq, rc=rc, ln=ln, D=D, Ds=Ds, one=one)


def _contract(ref: dict, got: dict) -> None:
    """Fields equal below n_alns on the reads `ref` finished; `got`'s
    overflow set a subset of `ref`'s."""
    ok = ~ref["overflow"]
    assert ok.sum() > 0 and int(ref["n_alns"][ok].sum()) > 0
    assert not got["overflow"][ok].any()
    for k in PER_READ:
        np.testing.assert_array_equal(ref[k][ok], got[k][ok], err_msg=k)


@pytest.mark.parametrize("dp,tp", MESHES)
def test_sharded_search_equals_one_device_and_jax(world, dp, tp):
    w = world
    one = w["one"]
    mesh = make_mesh(dp, tp, devices=CPU8)
    got = sharded_inexact_search(mesh, w["tdx"], w["rc"], w["ln"], w["D"],
                                 w["Ds"], AlnParams(max_diff=2), CFG)
    # the one-device run and the mesh run: every output equal (the
    # arena's lanes joined in lane order, o_lane global)
    assert set(got) == set(one)
    for k in one:
        assert torch.equal(got[k], one[k]), k
    g, _ = as_numpy(got)

    jout, _ = as_numpy(j_sharded_search(
        j_make_mesh(dp, tp), w["jdx"], jnp.asarray(w["rc"]),
        jnp.asarray(w["ln"]), jnp.asarray(w["D"].numpy()),
        jnp.asarray(w["Ds"].numpy()), JParams(max_diff=2),
        JConfig(cap=CAP, acap=ACAP, kx=KX, max_iters=MAX_ITERS,
                backend="xla")))
    _contract(jout, g)


@pytest.mark.parametrize("entry", ["search", "align_step"])
def test_members_inputs_staged_before_the_first_launch(world, monkeypatch,
                                                        entry):
    """The dp members' launches overlap across cards only if no member's
    inputs are copied inside its own dispatch and no host work sits
    between the launches: every member's inputs are staged on its device
    and every member's launch prepared before the first launch, each
    launch gets the staged tensors, on its member's device, in the types
    its launch takes, and `_search_inputs` copies none of them again.
    Outputs unchanged."""
    w = world
    p = AlnParams(max_diff=2)
    n = 10                                   # padded to 12 lanes at dp = 3
    mesh = make_mesh(3, 1, devices=CPU8)
    members = mesh.place(w["tdx"])

    def run():
        if entry == "search":
            return shard.sharded_inexact_search(
                mesh, w["tdx"], w["rc"][:n], w["ln"][:n], w["D"][:n],
                w["Ds"][:n], p, CFG)
        return shard.sharded_align_step(mesh, w["tdx"], w["seq"][:n],
                                        w["rc"][:n], w["ln"][:n], p, CFG,
                                        d_cap=16)

    ref = run()
    events: list = []
    staged_ptrs: set = set()
    real_stage, real_search = shard._stage, shard.inexact_search

    def stage(ms, arrs, dtypes):
        out = real_stage(ms, arrs, dtypes)
        for m, xs in zip(ms, out):
            events.append(("stage", m))
            staged_ptrs.update(x.data_ptr() for x in xs)
        return out

    def search(m, rc, lengths, D, Ds, params, cfg, device=None, timer=None,
               defer=False):
        events.append(("prepare", m))
        assert device == m.device and defer
        for x, dt in ((rc, torch.int8), (lengths, torch.int32)):
            assert x.device == m.device and x.dtype == dt
            assert x.data_ptr() in staged_ptrs
        got = t_inexact._search_inputs(m, rc, lengths, D, Ds, None, None,
                                       None, device)
        assert got[1] is rc and got[2] is lengths
        if entry == "search":
            assert got[3] is D and got[4] is Ds
        go = real_search(m, rc, lengths, D, Ds, params, cfg, device=device,
                         timer=timer, defer=True)

        def launch():
            events.append(("launch", m))
            return go()
        return launch

    monkeypatch.setattr(shard, "_stage", stage)
    monkeypatch.setattr(shard, "inexact_search", search)
    got = run()
    assert [k for k, _ in events] == (["stage"] * 3 + ["prepare"] * 3
                                      + ["launch"] * 3)
    assert [m for _, m in events[3:6]] == members
    assert [m for _, m in events[6:]] == members
    assert set(got) == set(ref)
    for k in ref:
        assert torch.equal(got[k], ref[k]), k
    if entry == "search":
        for k in w["one"]:
            assert torch.equal(got[k], w["one"][k][:n]), k


def test_deferred_launch_reads_its_outputs_after_the_launch(world,
                                                            monkeypatch):
    """kernel.fixed_search(defer=True) launches nothing until its callable
    is called, and builds its result dict from the outputs as the launch
    left them: a stand-in launch that writes its outputs only when fired
    (the wrapper's own launch needs a card)."""
    w = world
    p = AlnParams(max_diff=2)
    fired: list = []

    def launch(entry, didx, rc, lengths, D, Ds, params, cfg, lanes, seeds,
               timer=None, defer=False):
        S = t_inexact.ring_statics(params, cfg, rc.shape[1], Ds.shape[1],
                                   fixed=True)
        outs = t_inexact.alloc_outputs(rc.shape[0], S, "cpu") + (None,)

        def go():
            fired.append(entry)
            outs[1][:, t_inexact.META_OVER] = 1
            outs[1][:, t_inexact.META_WORK] = 5
            return outs
        return go if defer else go()

    monkeypatch.setattr(kernel, "_launch", launch)
    go = kernel.fixed_search(w["tdx"], w["rc"], w["ln"], w["D"], w["Ds"], p,
                             CFG, defer=True)
    assert fired == []
    out = go()
    assert fired == ["fixed_search"]
    assert out["overflow"].all() and (out["n_work"] == 5).all()


def test_tp_gather_equals_unsharded_rows(world):
    """Range-sharded rows and ranks == the unsharded ones, for block ids
    across every shard (8 shards: the table is padded to a multiple)."""
    tdx = world["tdx"]
    mesh = make_mesh(1, 8, devices=CPU8)
    m = mesh.place(tdx)[0]
    assert len(m.tp_tables) == 8 and tdx.num_blocks % 8 != 0
    k = torch.arange(tdx.num_blocks)
    assert torch.equal(_take_rows(m, k), tdx.table)
    rng = np.random.default_rng(0)
    i = torch.from_numpy(rng.integers(-1, tdx.length, 64).astype(np.int32))
    assert torch.equal(rank_all_dfs(m, i, 1), rank_all_dfs(tdx, i, 1))
    # D bounds through the sharded pass equal one device's, padding a
    # batch of 10 reads to 12 lanes at dp = 3
    w = world
    p = AlnParams(max_diff=2)
    ref = chunk_bounds(tdx, w["seq"][:10], w["ln"][:10], p, 16)
    got = sharded_calc_d_chunk(make_mesh(3, 2, devices=CPU8), tdx,
                               w["seq"][:10], w["ln"][:10], p, 16)
    for a, b in zip(ref, got):
        assert torch.equal(a, b)


def test_sharded_align_step_ref_pos_equals_jax(world, small_world):
    """D, seed D, search and SA resolution of each read's first alignment,
    10 reads (padded to a dp multiple), against the JAX step."""
    w = world
    n = 10
    mesh = make_mesh(2, 2, devices=CPU8)
    got = sharded_align_step(mesh, w["tdx"], w["seq"][:n], w["rc"][:n],
                             w["ln"][:n], AlnParams(max_diff=2), CFG,
                             d_cap=16)
    ref = j_align_step(j_make_mesh(4, 2), w["jdx"],
                       jnp.asarray(w["seq"][:n].astype(np.int32)),
                       jnp.asarray(w["rc"][:n].astype(np.int32)),
                       jnp.asarray(w["ln"][:n]), JParams(max_diff=2),
                       JConfig(cap=CAP, acap=ACAP, kx=KX,
                               max_iters=MAX_ITERS), d_cap=16)
    n_alns = got["n_alns"].numpy()
    ref_pos = got["ref_pos"].numpy()
    ok = ~np.asarray(ref["overflow"])
    assert n_alns.shape == (n,) and n_alns[ok].sum() > 0
    assert not got["overflow"].numpy()[ok].any()
    np.testing.assert_array_equal(n_alns[ok], np.asarray(ref["n_alns"])[ok])
    np.testing.assert_array_equal(ref_pos[ok],
                                  np.asarray(ref["ref_pos"])[ok])
    idx = small_world["idx"]
    for b in np.flatnonzero(n_alns > 0):
        assert ref_pos[b] == idx.SA(int(got["o_L"][b, 0]))


PIPE_PARAMS = AlnParams(max_diff=2, batch_size=64)
PIPE_CFG = EngineConfig(cap=8192, acap=16, kx=8, max_iters=50_000)


def _pipe_run(idx, didx, reads, **kw):
    stats: dict = {}
    alns = align_reads_device(idx, didx, reads, PIPE_PARAMS, PIPE_CFG,
                              d_cap=16, device="cpu", stats=stats, **kw)
    return b"".join(encode_alns(a) for a in alns), stats


@pytest.fixture(scope="module")
def pipe(small_world):
    """The mesh pipeline's inputs, the one-device run's `.aln` bytes (no
    native library) and the JAX package's mesh `.aln` bytes (mesh 4 x 2,
    as tests/test_parallel.py runs it)."""
    idx = FMIndex.build(small_world["codes"])
    reads = read_fastq(small_world["fastq"])
    didx = from_fmindex(idx, device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(t_native, "_native", None)
        mp.setattr(t_native, "_tried", True)
        one, _ = _pipe_run(idx, didx, reads)
    jidx = small_world["idx"]
    jalns = j_align_device(jidx, j_from_fmindex(jidx), small_world["reads"],
                           JParams(max_diff=2, batch_size=64),
                           JConfig(cap=8192, acap=16, kx=8,
                                   max_iters=50_000), d_cap=16,
                           mesh=j_make_mesh(4, 2))
    return idx, didx, reads, one, b"".join(j_encode(a) for a in jalns)


@pytest.mark.parametrize("dp,tp", [(2, 1), (2, 2)])
def test_mesh_pipeline_aln_bytes_equal_one_device_and_jax(pipe, no_native,
                                                          dp, tp):
    idx, didx, reads, one, jax_bytes = pipe
    got, stats = _pipe_run(idx, didx, reads,
                           mesh=make_mesh(dp, tp, devices=CPU8))
    assert got == one == jax_bytes
    assert stats["launches"] >= 1 and not stats.get("streamed")


def test_make_mesh_refuses_more_devices_than_given():
    with pytest.raises(ValueError, match="needs 8 devices, have 4"):
        make_mesh(4, 2, devices=CPU8[:4])
    mesh = make_mesh(2, 3, devices=CPU8)
    assert mesh.shape == {"dp": 2, "tp": 3}
    assert len(jax.devices()) >= 8        # the JAX side's virtual devices
