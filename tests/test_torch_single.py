"""Single-genome (`-S`) mode of the port: the 4-letter rank projection, exact
search, D bounds, the fixed and the queued search, the pipeline and the CLI
against the JAX package and the gold engine.  On the CPU the wrappers run
the plain version.  Integers and bytes: the tolerance is zero."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bwbble_tpu.align.params import AlnParams as JParams
from bwbble_tpu.engine import dbound as JD
from bwbble_tpu.engine import device_index as JDI
from bwbble_tpu.engine import exact as JE
from bwbble_tpu.engine import rank as JR
from bwbble_tpu.engine.inexact import EngineConfig as JConfig
from bwbble_tpu.engine.inexact import inexact_search_queued as j_queued
from bwbble_tpu.engine.inexact import unpack_paths as j_unpack
from bwbble_tpu.engine.pipeline import _calc_d_chunk as j_calc_d_chunk
from bwbble_tpu.engine.pipeline import align_reads_device as j_align_device
from bwbble_tpu.formats.aln import encode_alns as j_encode

from bwbble_tpu_torch import worlds
from bwbble_tpu_torch.align.params import AlnParams
from bwbble_tpu_torch.align.pipeline import align_read_gold, align_reads_gold
from bwbble_tpu_torch.engine import dbound as TD
from bwbble_tpu_torch.engine import exact as TE
from bwbble_tpu_torch.engine import rank as TR
from bwbble_tpu_torch.engine.device_index import from_fmindex
from bwbble_tpu_torch.engine.inexact import (EngineConfig,
                                             inexact_search_queued,
                                             unpack_paths)
from bwbble_tpu_torch.engine.pipeline import (_reconstruct_path,
                                              align_reads_device)
from bwbble_tpu_torch.formats.aln import encode_alns, write_aln_file
from bwbble_tpu_torch.formats.fasta import fasta2ref
from bwbble_tpu_torch.formats.fastq import read_fastq
from bwbble_tpu_torch.index import FMIndex
from bwbble_tpu_torch.testutil import (random_genome_fasta,
                                       simulate_reads_fastq)
from test_torch_fixed import (PER_READ, as_numpy, both_indexes,
                              check_contract, fixed_both)

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JP = JParams(max_diff=3, batch_size=128, is_multiref=False)
TP = AlnParams(max_diff=3, batch_size=128, is_multiref=False)


@pytest.fixture(scope="module")
def world():
    idx, reads = worlds.single_genome_world()
    return (idx,) + both_indexes(idx) + (reads,)


def test_rank_actg_dfs_equal(world):
    idx, jdx, tdx, _ = world
    rng = np.random.default_rng(8)
    edge = [-1, 0, 1, 127, 128, idx.length - 2, idx.length - 1]
    iL = np.concatenate([rng.integers(-1, idx.length, 500),
                         edge]).astype(np.int32)
    iU = iL[::-1].copy()
    for inc in (0, 1):
        np.testing.assert_array_equal(
            np.asarray(JR.rank_actg_dfs(jdx, jnp.asarray(iL), inc)),
            TR.rank_actg_dfs(tdx, torch.from_numpy(iL), inc).numpy())
    a = JR.rank_actg_dfs_pair(jdx, jnp.asarray(iL), jnp.asarray(iU))
    b = TR.rank_actg_dfs_pair(tdx, torch.from_numpy(iL),
                              torch.from_numpy(iU))
    for x, y in zip(a, b):
        assert y.shape == (iL.size, 5)
        np.testing.assert_array_equal(np.asarray(x), y.numpy())


def test_exact_search_1to1_and_calc_d_1to1_equal(world):
    idx, jdx, tdx, reads = world
    seq = np.asarray(reads.seq, dtype=np.int8).copy()
    seq[3, 7] = 4                                   # an N inside a read
    lengths = reads.lengths.astype(np.int32).copy()
    lengths[5] = 20
    a = JE.exact_search_1to1(jdx, jnp.asarray(seq), jnp.asarray(lengths))
    b = TE.exact_search_1to1(tdx, seq, lengths, device="cpu")
    alive = np.asarray(a[2])
    np.testing.assert_array_equal(alive, b[2].numpy())
    assert 0 < alive.sum() < alive.size
    for x, y in zip(a[:2], b[:2]):
        np.testing.assert_array_equal(np.asarray(x)[alive],
                                      y.numpy()[alive])
    for max_len in (None, 16):
        ln = lengths if max_len is None else np.minimum(lengths, max_len)
        ja, jo = JD.calc_d_1to1(jdx, jnp.asarray(seq), jnp.asarray(ln),
                                max_len=max_len)
        ta, to = TD.calc_d_1to1(tdx, seq, ln, max_len=max_len, device="cpu")
        np.testing.assert_array_equal(np.asarray(ja), ta.numpy())
        assert not np.asarray(jo).any() and not to.numpy().any()
        assert int(ta[:, :, 0].max()) > 0


@pytest.mark.parametrize("cap,kx", [(4096, 4)])
def test_single_genome_fixed_search_matches_jax_xla_body(world, cap, kx):
    idx, jdx, tdx, reads = world
    ref, rlive, got, glive = fixed_both(
        jdx, tdx, np.asarray(reads.seq, dtype=np.int8),
        np.asarray(reads.rc, dtype=np.int8), reads.lengths.astype(np.int32),
        JP, TP, cap, kx)
    check_contract(ref, rlive, got, glive, 4, reads.max_len + 32)
    assert got["arena"].shape[2] == 40 and not got["o_snp"].any()


def test_single_genome_queued_search_matches_jax_xla_body(world):
    """Fewer lanes than reads on both sides; same list capacity and ring
    budget, so the same overflow set."""
    idx, jdx, tdx, reads = world
    rc = np.tile(np.asarray(reads.rc, dtype=np.int8), (2, 1))
    lengths = np.tile(reads.lengths.astype(np.int32), 2)
    D, Ds, _ = j_calc_d_chunk(jdx, jnp.asarray(rc), jnp.asarray(lengths),
                              lengths, JP, K=16)
    for cap in (4096, 9 * 60 + 1):
        ref, _ = as_numpy(j_queued(
            jdx, jnp.asarray(rc), jnp.asarray(lengths), D, Ds, JP,
            JConfig(cap=cap, acap=24, kx=4, max_iters=20_000, flush=16,
                    backend="xla"), lanes=128))
        got, _ = as_numpy(inexact_search_queued(
            tdx, rc, lengths, np.array(D), np.array(Ds), TP,
            EngineConfig(cap=cap, acap=24, kx=4, max_iters=20_000),
            lanes=40, device="cpu"))
        np.testing.assert_array_equal(ref["overflow"], got["overflow"])
        ok = ~got["overflow"]
        assert ok.sum() > 0 and (cap > 4000 or (~ok).sum() > 0)
        for k in PER_READ:
            np.testing.assert_array_equal(ref[k][ok], got[k][ok], err_msg=k)
        pc = reads.max_len + 32
        live = (np.arange(24)[None, :] < got["n_alns"][:, None])[:, :, None]
        np.testing.assert_array_equal(
            np.where(live, j_unpack(ref["paths"], pc), 0)[ok],
            np.where(live, unpack_paths(got["paths"], pc), 0)[ok])


def test_single_genome_search_matches_gold(world):
    """Every alignment of the queued 4-letter search equals the gold
    engine's, paths included."""
    idx, jdx, tdx, reads = world
    rc = np.asarray(reads.rc, dtype=np.int8)
    lengths = reads.lengths.astype(np.int32)
    D, Ds, _ = j_calc_d_chunk(
        jdx, jnp.asarray(np.asarray(reads.seq, dtype=np.int8)),
        jnp.asarray(lengths), lengths, JP, K=16)
    got, _ = as_numpy(inexact_search_queued(
        tdx, rc, lengths, np.array(D), np.array(Ds), TP,
        EngineConfig(cap=16384, acap=32, kx=4, max_iters=50_000), lanes=48,
        device="cpu"))
    assert not got["overflow"].any()
    paths = unpack_paths(got["paths"], reads.max_len + 32)
    n = 0
    for b in range(reads.count):
        gold = align_read_gold(idx, reads.seq[b], reads.rc[b],
                               int(reads.lengths[b]), TP)
        assert int(got["n_alns"][b]) == len(gold), f"read {b} count"
        for k, ga in enumerate(gold):
            assert (int(got["o_L"][b, k]), int(got["o_U"][b, k]),
                    int(got["o_score"][b, k]), int(got["o_mm"][b, k]),
                    int(got["o_go"][b, k]), int(got["o_ge"][b, k]),
                    int(got["o_len"][b, k])) == \
                (ga.L, ga.U, ga.score, ga.num_mm, ga.num_gapo, ga.num_gape,
                 ga.aln_length), f"read {b} aln {k}"
            assert _reconstruct_path(
                paths[b][k], int(got["o_plen"][b, k]),
                int(got["o_len"][b, k]), 0) == ga.path
            n += 1
    assert n > reads.count // 2


# ---------------------------------------------------------------- pipeline

@pytest.fixture(scope="module")
def pipe_world(tmp_path_factory):
    d = tmp_path_factory.mktemp("single")
    fa, fq = str(d / "s.fa"), str(d / "s.fq")
    random_genome_fasta(fa, {"1": 20_000}, seed=31)
    simulate_reads_fastq(fa, fq, 150, read_len=36, mm_poisson=1.0, mm_cap=2,
                         indel_frac=0.1, max_indel=1, seed=32)
    codes, _ = fasta2ref(fa, fa + ".ref", fa + ".ann")
    idx = FMIndex.build(codes)
    idx.store(fa + ".bwt")
    reads = read_fastq(fq)
    params = AlnParams(max_diff=2, batch_size=128, is_multiref=False)
    gold = b"".join(encode_alns(a)
                    for a in align_reads_gold(idx, reads, params))
    return dict(dir=d, fa=fa, fq=fq, idx=idx, reads=reads, params=params,
                gold=gold)


@pytest.mark.parametrize("queued", [False, True])
def test_single_genome_pipeline_bytes_equal_jax_and_gold(pipe_world, queued):
    w = pipe_world
    didx = from_fmindex(w["idx"], device="cpu")
    stats: dict = {}
    alns = align_reads_device(w["idx"], didx, w["reads"], w["params"],
                              EngineConfig(cap=4096, acap=24), d_cap=16,
                              queued=queued, qchunk=1, stats=stats,
                              device="cpu")
    got = b"".join(encode_alns(a) for a in alns)
    assert got == w["gold"]
    assert stats["launches"] >= 2 and stats["fallback_reads"] < 15
    if not queued:
        jalns = j_align_device(
            w["idx"], JDI.from_fmindex(w["idx"]), w["reads"],
            JParams(max_diff=2, batch_size=128, is_multiref=False),
            JConfig(cap=4096, acap=24), d_cap=16, deep_tiers=False)
        assert got == b"".join(j_encode(a) for a in jalns)


def test_cli_align_single_genome_equals_jax_gold_cli(pipe_world, tmp_path):
    w = pipe_world
    env = dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu")

    def run(*argv):
        r = subprocess.run([sys.executable, "-m", *argv], cwd=str(tmp_path),
                           env=env, capture_output=True, text=True,
                           timeout=600)
        assert r.returncode == 0, r.stdout + r.stderr

    run("bwbble_tpu_torch", "align", "-n", "2", "-S", "--batch", "128",
        "--arena", "4096", "--device", "cpu", w["fa"], w["fq"],
        str(tmp_path / "t.aln"))
    run("bwbble_tpu.cli", "align", "-n", "2", "-S", "--engine", "gold",
        w["fa"], w["fq"], str(tmp_path / "j.aln"))
    data = (tmp_path / "t.aln").read_bytes()
    assert data == (tmp_path / "j.aln").read_bytes() == w["gold"]
    write_aln_file(str(tmp_path / "g.aln"),
                   align_reads_gold(w["idx"], w["reads"], w["params"]))
    assert data == (tmp_path / "g.aln").read_bytes()
