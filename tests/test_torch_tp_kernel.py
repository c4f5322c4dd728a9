"""The search kernel on a range-sharded table (tp > 1), on the CPU: the
kernel's source compiled with g++ against csrc/warp_emu.h (the `emu_lib`
fixture of tests/test_torch_kernel_emulated.py) and launched through its C
entry with the shards of `Mesh.place`, held against the plain version on
the same sharded index and against the emulated launch on the unsharded
index (every per-read field, path, overflow reason and counter equal,
tolerance zero), in all four fixed instantiations; at mesh (1, 2) against
the JAX package's sharded search on its 8 virtual CPU devices, by the
subset rule of tests/test_torch_parallel.py; then the wrapper's and the C
entry's refusals, and peer access through the emulator's table of cards."""

import ctypes
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bwbble_tpu.align.params import AlnParams as JParams
from bwbble_tpu.engine.inexact import EngineConfig as JConfig
from bwbble_tpu.parallel import make_mesh as j_make_mesh
from bwbble_tpu.parallel import sharded_inexact_search as j_sharded_search

from bwbble_tpu_torch import worlds
from bwbble_tpu_torch.align.params import AlnParams
from bwbble_tpu_torch.align.precalc import build_precalc_gold, read_indices
from bwbble_tpu_torch.engine import kernel
from bwbble_tpu_torch.engine.device_index import DeviceIndex, from_fmindex
from bwbble_tpu_torch.engine.inexact import (EngineConfig, alloc_outputs,
                                             fixed_search_plain, ring_statics)
from bwbble_tpu_torch.parallel import make_mesh
from bwbble_tpu_torch.parallel.shard import peer_pairs
from test_torch_fixed import as_numpy
from test_torch_kernel_emulated import (CFG, P3, PS, _emulated, _exact_d,
                                        emu_lib)  # noqa: F401
from test_torch_parallel import CFG as PCFG
from test_torch_parallel import _contract, world  # noqa: F401

torch.set_num_threads(1)

CPU8 = [torch.device("cpu")] * 8
CFG4 = EngineConfig(cap=4096, kx=4)

# (name, world, params, cfg, int64): the four fixed instantiations
CASES = [
    ("multi", "mixed", P3, CFG, False),
    ("single", "single", PS, CFG4, False),
    ("multi int64", "mixed", P3, CFG, True),
    ("single int64", "single", PS, CFG4, True),
]


def _inputs(world_name, params, x64, n_reads=8):
    make = worlds.mixed_world if world_name == "mixed" else \
        worlds.single_genome_world
    idx, rd = make(n_reads=n_reads)
    didx = from_fmindex(idx, use_int64=x64, device="cpu")
    D, Ds = _exact_d(idx, rd, params)
    a = [torch.from_numpy(np.asarray(rd.rc, dtype=np.int8)),
         torch.from_numpy(rd.lengths.astype(np.int32)),
         torch.from_numpy(D).to(didx.idt), torch.from_numpy(Ds).to(didx.idt)]
    return didx, a


def _equal(ref: dict, got: dict) -> list:
    """Keys whose values differ (the lane that served a read and the
    arena's scratch rows are free)."""
    return [k for k, v in ref.items() if k not in ("o_lane", "arena")
            and not torch.equal(v.to(torch.int64), got[k].to(torch.int64))]


@pytest.mark.parametrize("tp", [2, 3])
@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_sharded_kernel_equals_plain_and_unsharded(emu_lib, case, tp):
    _name, wname, p, cfg, x64 = case
    didx, a = _inputs(wname, p, x64)
    sharded = make_mesh(1, tp, devices=CPU8).place(didx)[0]
    nloc = sharded.tp_tables[0].shape[0]
    assert len(sharded.tp_tables) == tp
    # 63 blocks: tp = 2 pads the last shard with one zero row, tp = 3 not
    assert (nloc * tp > didx.num_blocks) == (didx.num_blocks % tp != 0)
    got, _S = _emulated(emu_lib, sharded, *a, p, cfg, None, None)
    one, _S = _emulated(emu_lib, didx, *a, p, cfg, None, None)
    ref = fixed_search_plain(sharded, *a, p, cfg, None)
    assert int(got["n_alns"].sum()) > 0 and int(got["pops"].sum()) > 0
    assert not _equal(ref, got)
    assert not _equal(one, got)
    # the rows come from the shards through the pointers given: the same
    # shards in another order give another result
    swapped = DeviceIndex(**{**sharded.__dict__, "tp_tables": (
        sharded.tp_tables[1], sharded.tp_tables[0])
        + sharded.tp_tables[2:]})
    other, _S = _emulated(emu_lib, swapped, *a, p, cfg, None, None)
    assert _equal(one, other)


def test_seeded_sharded_kernel_equals_plain(emu_lib):
    """Seeded roots on a sharded table (`fixed_search_seeded_tp`)."""
    idx, rd = worlds.mixed_world(n_reads=8)
    didx = from_fmindex(idx, device="cpu")
    p = dataclasses.replace(P3, precalc_len=4, use_precalc=True)
    D, Ds = _exact_d(idx, rd, p)
    a = [torch.from_numpy(np.asarray(rd.rc, dtype=np.int8)),
         torch.from_numpy(rd.lengths.astype(np.int32)),
         torch.from_numpy(D), torch.from_numpy(Ds)]
    table = build_precalc_gold(idx, AlnParams(), k=4)
    ri = read_indices(np.asarray(rd.rc, dtype=np.int8),
                      rd.lengths.astype(np.int32), k=4)
    sL, sU, scnt, _ = table.lookup_batch(ri, 8)
    sd = (torch.from_numpy(sL.astype(np.int32)),
          torch.from_numpy(sU.astype(np.int32)),
          torch.from_numpy(scnt.astype(np.int32)))
    sharded = make_mesh(1, 2, devices=CPU8).place(didx)[0]
    got, _S = _emulated(emu_lib, sharded, *a, p, CFG, None, sd)
    ref = fixed_search_plain(sharded, *a, p, CFG, sd)
    assert int(got["root_rd"].sum()) > 0
    assert not _equal(ref, got)


def test_sharded_kernel_at_mesh_1_2_against_jax(emu_lib, world):
    """The emulated sharded kernel at mesh (1, 2) on the JAX tests' small
    world against the JAX package's sharded search at (1, 2): every read
    the JAX batch finishes has equal fields, and the port's overflow set
    is a subset of JAX's."""
    w = world
    p = AlnParams(max_diff=2)
    sharded = make_mesh(1, 2, devices=CPU8).place(w["tdx"])[0]
    a = [torch.from_numpy(w["rc"]), torch.from_numpy(w["ln"]), w["D"],
         w["Ds"]]
    got, _S = _emulated(emu_lib, sharded, *a, p, PCFG, None, None)
    assert not _equal(w["one"], got)
    jout, _ = as_numpy(j_sharded_search(
        j_make_mesh(1, 2), w["jdx"], jnp.asarray(w["rc"]),
        jnp.asarray(w["ln"]), jnp.asarray(w["D"].numpy()),
        jnp.asarray(w["Ds"].numpy()), JParams(max_diff=2),
        JConfig(cap=PCFG.cap, acap=PCFG.acap, kx=PCFG.kx,
                max_iters=PCFG.max_iters, backend="xla")))
    g, _ = as_numpy({k: v for k, v in got.items() if k != "arena"})
    _contract(jout, g)


def test_shard_args_and_wrapper_refusals():
    """The pointers and rows the wrapper hands the C entry, and what it
    refuses before any device check: more than 8 shards, unequal shards,
    a shard of another width, shards too small for the length, a ring
    launch on shards."""
    idx, rd = worlds.mixed_world(n_reads=4)
    didx = from_fmindex(idx, device="cpu")
    ptrs, tp, nloc = kernel.shard_args(didx)
    assert (tp, nloc) == (1, didx.num_blocks)
    assert int(ptrs[0]) == didx.table.data_ptr() and not ptrs[1:].any()
    for n in (2, 3, 8):
        m = make_mesh(1, n, devices=CPU8).place(didx)[0]
        ptrs, tp, nloc = kernel.shard_args(m)
        assert (tp, nloc) == (n, -(-didx.num_blocks // n))
        assert [int(x) for x in ptrs[:n]] == [s.data_ptr()
                                              for s in m.tp_tables]
        assert not ptrs[n:].any()
    m2 = make_mesh(1, 2, devices=CPU8).place(didx)[0]
    t0, t1 = m2.tp_tables
    bad = {
        "at most 8": make_mesh(1, 9, devices=[torch.device("cpu")] * 9)
        .place(didx)[0],
        "like shard 0": DeviceIndex(**{**m2.__dict__,
                                       "tp_tables": (t0, t1[:-1])}),
        "int32 tensor": DeviceIndex(**{**m2.__dict__, "tp_tables": (
            t0, t1.to(torch.int64))}),
        "do not hold": DeviceIndex(**{**m2.__dict__, "table": t0[:8],
                                      "tp_tables": (t0[:8], t1[:8])}),
    }
    for match, d in bad.items():
        with pytest.raises(ValueError, match=match):
            kernel.shard_args(d)
    rc = torch.from_numpy(np.asarray(rd.rc, dtype=np.int8))
    ln = torch.from_numpy(rd.lengths.astype(np.int32))
    D = torch.zeros((rd.count, rd.max_len + 1, 2), dtype=torch.int32)
    Ds = torch.zeros((rd.count, 33, 2), dtype=torch.int32)
    before = dict(kernel.LAUNCHES)
    with pytest.raises(ValueError, match="ring launch takes no sharded"):
        kernel.ring_search(m2, rc, ln, D, Ds, P3, CFG, lanes=4)
    for match, d in bad.items():
        with pytest.raises(ValueError, match=match):
            kernel.fixed_search(d, rc, ln, D, Ds, P3, CFG)
    # a valid sharded index of CPU tensors is refused as every CPU index is
    with pytest.raises(ValueError, match="CUDA"):
        kernel.fixed_search(m2, rc, ln, D, Ds, P3, CFG)
    assert kernel.LAUNCHES == before


def test_c_entry_refuses_bad_shards(emu_lib):
    """`ring_search_launch` returns -1, launching nothing, for a ring launch
    on shards, tp outside 1..8, a null shard, or shards whose rows do not
    hold the blocks of the length."""
    didx, a = _inputs("mixed", P3, False, n_reads=4)
    m = make_mesh(1, 2, devices=CPU8).place(didx)[0]
    ptrs, tp, nloc = kernel.shard_args(m)
    emu_lib.emu_trace.restype = ctypes.c_char_p
    Q, Lmax = a[0].shape

    def launch(fixed, ptrs_, tp_, nloc_):
        S = ring_statics(P3, CFG, Lmax, a[3].shape[1], fixed=fixed)
        lanes = Q if fixed else 2
        hp = kernel.param_block(P3, S, Q, Lmax, int(didx.length), lanes)
        q_alns, q_meta, q_paths = alloc_outputs(Q, S, "cpu")
        arena = torch.zeros((lanes, S.NFRAME, S.ROWW), dtype=torch.int32)
        counter = torch.zeros((1,), dtype=torch.int32)
        return emu_lib.ring_search_launch(
            hp.ctypes.data, hp.size, 1, int(fixed), 0, ptrs_.ctypes.data,
            tp_, nloc_, didx.Carr.data_ptr(), *[x.data_ptr() for x in a],
            None, None, None, arena.data_ptr(), counter.data_ptr(),
            q_alns.data_ptr(), q_meta.data_ptr(), q_paths.data_ptr(), None,
            None, None)
    before = emu_lib.emu_trace()
    null1 = ptrs.copy()
    null1[1] = 0
    for args in ((False, ptrs, tp, nloc), (True, ptrs, 0, nloc),
                 (True, ptrs, 9, nloc), (True, null1, tp, nloc),
                 (True, ptrs, tp, nloc - 2), (True, ptrs, tp, 0)):
        assert launch(*args) == -1, args
    assert emu_lib.emu_trace() == before
    assert launch(True, ptrs, tp, nloc) == 0
    assert emu_lib.emu_trace() == before + b"k"


def test_peer_access(emu_lib, monkeypatch):
    """`ring_search_enable_peer` on the emulator's four cards: a pair is
    enabled once; enabling it again (as PyTorch may have done for its own
    copies) is success, and its error is cleared, so the next launch's
    error check finds none; a pair that cannot reach its peer returns the
    CUDA error; the current device is left as it was.  `kernel.enable_peer`
    takes an enabled pair again and raises with the error's text;
    `peer_pairs` names the pairs a mesh's sharded launches read across."""
    lib = emu_lib
    assert lib.emu_current_device() == 0
    assert lib.ring_search_enable_peer(2, 3) == 0
    assert lib.ring_search_enable_peer(2, 3) == 0      # already enabled
    assert lib.emu_current_device() == 0
    didx, a = _inputs("mixed", P3, False, n_reads=2)
    got, _S = _emulated(lib, make_mesh(1, 2, devices=CPU8).place(didx)[0],
                        *a, P3, CFG, None, None)      # its launch rc is 0
    assert lib.ring_search_enable_peer(1, 1) == 217    # unsupported
    assert lib.ring_search_enable_peer(0, 7) == 101    # invalid device
    assert lib.emu_current_device() == 0
    assert lib.ring_search_error_string(217) == (
        b"peer access is not supported between these two devices")

    monkeypatch.setitem(kernel._libs, "ring_search", lib)
    for _ in range(2):
        kernel.enable_peer(torch.device("cuda", 0), torch.device("cuda", 1))
    kernel.enable_peer(torch.device("cuda", 1), torch.device("cuda", 1))
    with pytest.raises(RuntimeError, match=r"cuda:0 to cuda:5 refused: "
                       r"CUDA error 101 \(invalid device ordinal\)"):
        kernel.enable_peer(torch.device("cuda", 0), torch.device("cuda", 5))
    assert lib.emu_current_device() == 0

    cuda = [torch.device("cuda", i) for i in range(4)]
    assert peer_pairs(make_mesh(1, 2, devices=[cuda[0]] * 2)) == []
    assert peer_pairs(make_mesh(2, 2, devices=[cuda[0]] * 4)) == []
    assert peer_pairs(make_mesh(1, 4, devices=cuda)) == [
        (cuda[0], cuda[1]), (cuda[0], cuda[2]), (cuda[0], cuda[3])]
    assert peer_pairs(make_mesh(2, 2, devices=cuda)) == [
        (cuda[0], cuda[1]), (cuda[2], cuda[3])]
    assert peer_pairs(make_mesh(4, 1, devices=cuda)) == []
