"""The port's ring search (bwbble_tpu_torch.engine.inexact, the module that
holds the CUDA kernel's wrapper and its plain PyTorch version) against the
JAX package's queued search and against the gold engine.  On the CPU the
wrapper runs the plain version.  All comparisons are of integers and bytes:
the tolerance is zero."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bwbble_tpu.align.params import AlnParams as JParams
from bwbble_tpu.engine import device_index as JDI
from bwbble_tpu.engine.inexact import EngineConfig as JConfig
from bwbble_tpu.engine.inexact import inexact_search_queued as j_search
from bwbble_tpu.engine.inexact import unpack_paths as j_unpack
from bwbble_tpu.engine.pipeline import _calc_d_chunk as j_calc_d_chunk

from bwbble_tpu_torch import worlds
from bwbble_tpu_torch.align.params import AlnParams
from bwbble_tpu_torch.align.pipeline import align_read_gold
from bwbble_tpu_torch.engine import device_index as TDI
from bwbble_tpu_torch.engine.inexact import (EngineConfig,
                                             inexact_search_queued,
                                             unpack_paths)
from bwbble_tpu_torch.engine.pipeline import _reconstruct_path
from bwbble_tpu_torch.gold.engine import calculate_d

torch.set_num_threads(1)

PER_READ = ("n_alns", "o_L", "o_U", "o_score", "o_len", "o_mm", "o_go",
            "o_ge", "o_snp", "o_plen")


@pytest.fixture(scope="module")
def world():
    idx, reads = worlds.mixed_world()
    jdx = JDI.from_fmindex(idx)
    tdx = TDI.from_arrays(np.asarray(jdx.table), np.asarray(jdx.Carr),
                          np.asarray(jdx.sa_samples), int(jdx.length),
                          int(jdx.sa0), device="cpu")
    return idx, jdx, tdx, reads


def _np(res):
    """Result dict as numpy, alignment slots past n_alns zeroed (the JAX
    queue body leaves a lane's earlier read's values there)."""
    out = {k: (v.numpy() if torch.is_tensor(v) else np.array(v))
           for k, v in res.items()}
    live = np.arange(out["o_L"].shape[1])[None, :] < out["n_alns"][:, None]
    for k in PER_READ[1:]:
        out[k] = np.where(live, out[k], 0)
    out["paths"] = np.where(live[:, :, None], out["paths"], 0)
    return out


def _both(world, cap, kx, tile=3, lanes=128, t_lanes=40):
    """The same numpy inputs through the JAX XLA queue body and the port."""
    idx, jdx, tdx, reads = world
    jp = JParams(max_diff=3, batch_size=128)
    tp = AlnParams(max_diff=3, batch_size=128)
    rc = np.tile(np.asarray(reads.rc, dtype=np.int8), (tile, 1))
    lengths = np.tile(reads.lengths.astype(np.int32), tile)
    D, Ds, _ = j_calc_d_chunk(jdx, jnp.asarray(rc), jnp.asarray(lengths),
                              lengths, jp, K=16)
    ref = _np(j_search(jdx, jnp.asarray(rc), jnp.asarray(lengths), D, Ds, jp,
                       JConfig(cap=cap, acap=24, kx=kx, max_iters=20_000,
                               flush=16, backend="xla"), lanes=lanes))
    got = _np(inexact_search_queued(
        tdx, rc, lengths, np.array(D), np.array(Ds), tp,
        EngineConfig(cap=cap, acap=24, kx=kx, max_iters=20_000),
        lanes=t_lanes, device="cpu"))
    return ref, got, reads


@pytest.mark.parametrize("cap,kx", [(16384, 4), (4096, 2)])
def test_plain_search_matches_jax_xla_body(world, cap, kx):
    """Per-read outputs and unpacked paths equal for reads that overflow on
    neither side, with fewer lanes than reads on both sides."""
    ref, got, reads = _both(world, cap, kx)
    ok = ~ref["overflow"] & ~got["overflow"]
    assert ok.sum() > 0
    # same list capacity and ring budget on both sides: same overflow set
    np.testing.assert_array_equal(ref["overflow"], got["overflow"])
    for k in PER_READ:
        np.testing.assert_array_equal(ref[k][ok], got[k][ok], err_msg=k)
    pc = reads.max_len + 32
    np.testing.assert_array_equal(j_unpack(ref["paths"], pc)[ok],
                                  unpack_paths(got["paths"], pc)[ok])
    assert int(got["n_alns"][ok].sum()) > 0


def test_plain_search_ring_overflow_matches_jax(world):
    """A tiny arena: the per-read ring budget (NFRAME pops) overflows some
    reads, and the overflow sets agree — the budget is per read on both
    sides."""
    ref, got, reads = _both(world, cap=23 * 12 + 1, kx=4, tile=2)
    assert 0 < got["overflow"].sum() < got["overflow"].size
    np.testing.assert_array_equal(ref["overflow"], got["overflow"])
    ok = ~got["overflow"]
    for k in PER_READ:
        np.testing.assert_array_equal(ref[k][ok], got[k][ok], err_msg=k)


def test_plain_search_matches_gold_on_dense_world(tmp_path):
    """IUPAC-dense world, exact D bounds from the gold calculate_d: with
    xcap=128 no read overflows where the kx=2 list capacity does, and every
    alignment equals the gold engine's, paths included."""
    idx, rd = worlds.iupac_dense_world(str(tmp_path), n_reads=16)
    tdx = TDI.from_fmindex(idx, device="cpu")
    params = AlnParams(max_diff=3, batch_size=128)
    Lmax = rd.max_len
    sl = int(params.seed_length)
    D = np.zeros((rd.count, Lmax + 1, 2), dtype=np.int32)
    Ds = np.zeros((rd.count, sl + 1, 2), dtype=np.int32)
    for r in range(rd.count):
        ln = int(rd.lengths[r])
        D[r, :ln + 1] = calculate_d(idx, rd.seq[r], ln, params)
        if ln > sl:
            Ds[r] = calculate_d(idx, rd.seq[r], sl, params)

    def run(cfg):
        return _np(inexact_search_queued(
            tdx, np.asarray(rd.rc, dtype=np.int8),
            rd.lengths.astype(np.int32), D, Ds, params, cfg, lanes=16,
            device="cpu"))

    narrow = run(EngineConfig(cap=131072, acap=24, kx=2, max_iters=60_000))
    assert narrow["overflow"].sum() > 0, "world too easy for kx=2"
    got = run(EngineConfig(cap=131072, acap=24, kx=2, max_iters=60_000,
                           xcap=128))
    assert got["overflow"].sum() == 0
    paths = unpack_paths(got["paths"], Lmax + 32)
    n_widened = 0
    for b in range(rd.count):
        gold = align_read_gold(idx, rd.seq[b], rd.rc[b], int(rd.lengths[b]),
                               params)
        assert int(got["n_alns"][b]) == len(gold), f"read {b} count"
        n_widened += int(bool(narrow["overflow"][b]) and len(gold) > 0)
        for k, ga in enumerate(gold):
            assert int(got["o_L"][b, k]) == ga.L, f"read {b} aln {k} L"
            assert int(got["o_U"][b, k]) == ga.U
            assert int(got["o_score"][b, k]) == ga.score
            assert int(got["o_mm"][b, k]) == ga.num_mm
            assert int(got["o_go"][b, k]) == ga.num_gapo
            assert int(got["o_ge"][b, k]) == ga.num_gape
            assert int(got["o_snp"][b, k]) & 0xFF == ga.num_snps
            assert int(got["o_len"][b, k]) == ga.aln_length
            path = _reconstruct_path(paths[b][k], int(got["o_plen"][b, k]),
                                     int(got["o_len"][b, k]), 0)
            assert path == ga.path, f"read {b} aln {k} path"
    assert n_widened > 0, "no read exercised the wide-list path"


def test_plain_search_all_discarded(world):
    """A queue of all-N reads (discarded at init) around two real ones
    terminates and equals the JAX queue body."""
    idx, jdx, tdx, reads = world
    jp = JParams(max_diff=3, batch_size=128)
    tp = AlnParams(max_diff=3, batch_size=128)
    Lmax, NR = reads.max_len, 384
    rc = np.full((NR, Lmax), 4, dtype=np.int8)
    rc[0] = np.asarray(reads.rc[0], dtype=np.int8)
    rc[97] = np.asarray(reads.rc[1], dtype=np.int8)
    lengths = np.full(NR, reads.lengths[0], dtype=np.int32)
    lengths[97] = int(reads.lengths[1])
    D, Ds, _ = j_calc_d_chunk(jdx, jnp.asarray(rc), jnp.asarray(lengths),
                              lengths, jp, K=16)
    ref = _np(j_search(jdx, jnp.asarray(rc), jnp.asarray(lengths), D, Ds, jp,
                       JConfig(cap=4096, acap=24, kx=4, max_iters=20_000,
                               flush=16, backend="xla"), lanes=128))
    got = _np(inexact_search_queued(
        tdx, rc, lengths, np.array(D), np.array(Ds), tp,
        EngineConfig(cap=4096, acap=24, kx=4, max_iters=20_000), lanes=128,
        device="cpu"))
    for k in ("n_alns", "o_L", "o_U", "o_score", "overflow", "paths"):
        np.testing.assert_array_equal(ref[k], got[k], err_msg=k)
    assert got["n_alns"][[0, 97]].min() >= 0 and got["n_alns"][1:97].sum() == 0
