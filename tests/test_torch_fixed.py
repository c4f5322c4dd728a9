"""The port's fixed-batch search (`inexact_search`, `walk_paths`) and the
fixed-tier pipeline (`align` without `--queued`) against the JAX package and
the gold engine.  On the CPU the wrapper runs the plain version.  All
comparisons are of integers and bytes: the tolerance is zero.

What a fixed batch promises (engine/inexact.py): the JAX batch is lockstep,
so its frame budget and `max_iters` count the waves of the whole launch; the
port's lanes do not wait for each other, so both are per read.  Every read
the JAX batch finishes, the port finishes with equal fields and paths; the
port's overflow set is a subset of the JAX one; with one read in the batch
the two clocks coincide and the flags are equal."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bwbble_tpu.align.params import AlnParams as JParams
from bwbble_tpu.engine import device_index as JDI
from bwbble_tpu.engine.inexact import EngineConfig as JConfig
from bwbble_tpu.engine.inexact import inexact_search as j_search
from bwbble_tpu.engine.inexact import walk_paths as j_walk
from bwbble_tpu.engine.pipeline import _calc_d_chunk as j_calc_d_chunk
from bwbble_tpu.engine.pipeline import align_reads_device as j_align_device
from bwbble_tpu.formats.aln import encode_alns as j_encode
from bwbble_tpu.formats.fastq import read_fastq as j_read_fastq
from bwbble_tpu.index import FMIndex as JFMIndex

from bwbble_tpu_torch import native as t_native
from bwbble_tpu_torch import worlds
from bwbble_tpu_torch.align.params import AlnParams
from bwbble_tpu_torch.align.pipeline import align_reads_gold
from bwbble_tpu_torch.engine import device_index as TDI
from bwbble_tpu_torch.engine.inexact import (EngineConfig, inexact_search,
                                             unpack_paths, walk_paths)
from bwbble_tpu_torch.engine.pipeline import align_reads_device
from bwbble_tpu_torch.formats.aln import encode_alns
from bwbble_tpu_torch.formats.fasta import fasta2ref
from bwbble_tpu_torch.formats.fastq import read_fastq
from bwbble_tpu_torch.index import FMIndex
from bwbble_tpu_torch.testutil import (random_genome_fasta,
                                       simulate_reads_fastq)
from test_torch_pipeline import native_lib, no_native  # noqa: F401

torch.set_num_threads(1)

PER_READ = ("n_alns", "o_L", "o_U", "o_score", "o_len", "o_mm", "o_go",
            "o_ge", "o_snp", "o_plen")


def both_indexes(idx):
    jdx = JDI.from_fmindex(idx)
    tdx = TDI.from_arrays(np.asarray(jdx.table), np.asarray(jdx.Carr),
                          np.asarray(jdx.sa_samples), int(jdx.length),
                          int(jdx.sa0), device="cpu")
    return jdx, tdx


def as_numpy(res):
    """Result dict as numpy, alignment slots past n_alns zeroed."""
    out = {k: (v.numpy() if torch.is_tensor(v) else np.array(v))
           for k, v in res.items()}
    live = np.arange(out["o_L"].shape[1])[None, :] < out["n_alns"][:, None]
    for k in PER_READ[1:] + ("o_node",):
        out[k] = np.where(live, out[k], 0)
    return out, live


def fixed_both(jdx, tdx, seq, rc, lengths, jp, tp, cap, kx,
               max_iters=20_000):
    """The same numpy inputs (reads, their reverse complements, D bounds of
    the reads) through the JAX XLA body and the port."""
    D, Ds, _ = j_calc_d_chunk(jdx, jnp.asarray(seq), jnp.asarray(lengths),
                              lengths, jp, K=16)
    ref, rlive = as_numpy(j_search(
        jdx, jnp.asarray(rc), jnp.asarray(lengths), D, Ds, jp,
        JConfig(cap=cap, acap=24, kx=kx, max_iters=max_iters,
                backend="xla")))
    got, glive = as_numpy(inexact_search(
        tdx, rc, lengths, np.array(D), np.array(Ds), tp,
        EngineConfig(cap=cap, acap=24, kx=kx, max_iters=max_iters),
        device="cpu"))
    return ref, rlive, got, glive


def j_paths(ref, live, nc, pathcap):
    """State walks of the JAX batch's reported alignments, [B, ACAP, PC]."""
    lanes, slots = np.nonzero(live)
    out = np.zeros(live.shape + (pathcap,), dtype=np.int8)
    if lanes.size:
        W = max(256, 1 << int(lanes.size - 1).bit_length())
        la = np.zeros(W, dtype=np.int32)
        na = np.full(W, -1, dtype=np.int32)
        la[:lanes.size] = lanes
        na[:lanes.size] = ref["o_node"][lanes, slots]
        pr = np.asarray(j_walk(ref["arena"], jnp.asarray(la),
                               jnp.asarray(na), nroot=1, nslot=1 + 2 * nc,
                               nc=nc, pathcap=pathcap))
        out[lanes, slots] = pr[:lanes.size]
    return out


def check_contract(ref, rlive, got, glive, nc, pathcap):
    """Fields and paths equal on the reads the JAX batch finished; the
    port's overflow set a subset of the JAX one; the in-kernel walk
    (`paths`) equal to `walk_paths` over the returned arena."""
    ok = ~ref["overflow"]
    assert ok.sum() > 0 and int(ref["n_alns"][ok].sum()) > 0
    assert not got["overflow"][ok].any(), "port overflowed a finished read"
    for k in PER_READ:
        np.testing.assert_array_equal(ref[k][ok], got[k][ok], err_msg=k)
    g_paths = unpack_paths(got["paths"], pathcap)
    np.testing.assert_array_equal(j_paths(ref, rlive, nc, pathcap)[ok],
                                  g_paths[ok])
    glive = glive & ~got["overflow"][:, None]
    lanes, slots = np.nonzero(glive)
    walked = walk_paths(torch.from_numpy(got["arena"]),
                        torch.from_numpy(lanes),
                        torch.from_numpy(got["o_node"][lanes, slots]),
                        nroot=1, nslot=1 + 2 * nc, nc=nc, pathcap=pathcap)
    np.testing.assert_array_equal(walked.numpy(), g_paths[lanes, slots])


@pytest.fixture(scope="module")
def world():
    idx, reads = worlds.mixed_world()
    return (idx,) + both_indexes(idx) + (reads,)


@pytest.mark.parametrize("cap,kx", [(16384, 4), (4096, 2)])
def test_fixed_search_matches_jax_xla_body(world, cap, kx):
    idx, jdx, tdx, reads = world
    seq = np.asarray(reads.seq, dtype=np.int8)
    rc = np.asarray(reads.rc, dtype=np.int8)
    lengths = reads.lengths.astype(np.int32)
    ref, rlive, got, glive = fixed_both(
        jdx, tdx, seq, rc, lengths, JParams(max_diff=3, batch_size=128),
        AlnParams(max_diff=3, batch_size=128), cap, kx)
    check_contract(ref, rlive, got, glive, 11, reads.max_len + 32)
    # interval-list and alignment-capacity overflows are per read in both
    assert got["overflow"].sum() <= ref["overflow"].sum()


def test_fixed_search_budget_equals_jax_with_one_read_in_the_batch(world):
    """A tiny arena and ONE read in the batch: the launch's wave clock is
    the read's own pop clock, so the overflow flags are equal, not only a
    subset.  The arenas sit right at the reads' own pop counts: a read
    whose NFRAME-th pop finishes it is finished on both sides, one that
    attempts one more pop is over budget on both."""
    idx, jdx, tdx, reads = world
    jp = JParams(max_diff=3, batch_size=128)
    tp = AlnParams(max_diff=3, batch_size=128)
    sq48 = np.asarray(reads.seq, dtype=np.int8)
    rc48 = np.asarray(reads.rc, dtype=np.int8)
    ln48 = reads.lengths.astype(np.int32)
    _, _, roomy, _ = fixed_both(jdx, tdx, sq48, rc48, ln48, jp, tp, 16384, 4)
    # the five aligned reads with the fewest pops; budgets around the second
    # smallest pop count
    done = np.flatnonzero(~roomy["overflow"] & (roomy["n_alns"] > 0)
                          & (roomy["pops"] > 8))
    picked = done[np.argsort(roomy["pops"][done], kind="stable")][:5]
    sq_all, rc_all, ln_all = sq48[picked], rc48[picked], ln48[picked]
    pops = roomy["pops"][picked]
    distinct = np.unique(pops)
    assert distinct.size >= 3
    mid = int(distinct[1])
    for nframe in (mid - 1, mid):
        cap = 23 * (nframe + 1) + 1
        for r in range(len(picked)):
            ref, _, got, _ = fixed_both(
                jdx, tdx, sq_all[r:r + 1], rc_all[r:r + 1], ln_all[r:r + 1],
                jp, tp, cap, 4, max_iters=100_000)
            over = bool(got["overflow"][0])
            assert bool(ref["overflow"][0]) == over, (nframe, picked[r])
            assert over == (pops[r] > nframe), (nframe, picked[r])
            if not over:
                for k in PER_READ:
                    np.testing.assert_array_equal(ref[k], got[k], err_msg=k)


def test_walk_paths_matches_jax_walk_paths(world):
    """The port's `walk_paths` on the JAX batch's own arena (frames moved
    behind the lane axis, as the port lays an arena out) and node ids gives
    the JAX `walk_paths` states."""
    idx, jdx, tdx, reads = world
    seq = np.asarray(reads.seq, dtype=np.int8)
    rc = np.asarray(reads.rc, dtype=np.int8)
    lengths = reads.lengths.astype(np.int32)
    ref, rlive, _, _ = fixed_both(
        jdx, tdx, seq, rc, lengths, JParams(max_diff=3, batch_size=128),
        AlnParams(max_diff=3, batch_size=128), 16384, 4)
    pc = reads.max_len + 32
    rlive = rlive & ~ref["overflow"][:, None]
    lanes, slots = np.nonzero(rlive)
    assert lanes.size > 10
    arena = torch.from_numpy(np.ascontiguousarray(
        ref["arena"].transpose(1, 0, 2)))
    walked = walk_paths(arena, torch.from_numpy(lanes),
                        torch.from_numpy(ref["o_node"][lanes, slots]),
                        nroot=1, nslot=23, nc=11, pathcap=pc)
    np.testing.assert_array_equal(
        walked.numpy(), j_paths(ref, rlive, 11, pc)[lanes, slots])
    assert int(walked.numpy().max()) == 2      # a deletion state was walked


# ---------------------------------------------------------------- pipeline

N_READS = 160


@pytest.fixture(scope="module")
def pipe_world(tmp_path_factory):
    d = tmp_path_factory.mktemp("fixed")
    fa, fq = str(d / "w.fa"), str(d / "w.fq")
    random_genome_fasta(fa, {"21": 24_000}, seed=21, iupac_frac=0.003)
    simulate_reads_fastq(fa, fq, N_READS, read_len=36, mm_poisson=1.0,
                         mm_cap=2, indel_frac=0.1, max_indel=1, seed=22)
    codes, _ = fasta2ref(fa, fa + ".ref", fa + ".ann")
    idx = FMIndex.build(codes)
    idx.store(fa + ".bwt")
    reads = read_fastq(fq)
    gold = b"".join(encode_alns(a) for a in align_reads_gold(
        idx, reads, AlnParams(max_diff=2)))
    return dict(fa=fa, fq=fq, idx=idx, reads=reads, gold=gold)


def run_port(w, params, cfg, stats, **kw):
    didx = TDI.from_fmindex(w["idx"], device="cpu")
    alns = align_reads_device(w["idx"], didx, w["reads"], params, cfg,
                              d_cap=32, stats=stats, device="cpu", **kw)
    return b"".join(encode_alns(a) for a in alns)


def test_fixed_pipeline_bytes_equal_jax_and_gold(pipe_world, no_native):
    """Two batches of the default path; without the native library D comes
    from the device pass and leftovers fall to the Python gold engine."""
    stats: dict = {}
    got = run_port(pipe_world, AlnParams(max_diff=2, batch_size=128),
                   EngineConfig(cap=4096, acap=24), stats,
                   deep_tiers=False)
    assert got == pipe_world["gold"]
    assert stats["launches"] == 2 and stats["pops"] > 0
    assert stats["tiers"][0]["reads"] == N_READS
    assert stats["fallback_reads"] < N_READS // 2

    jidx = JFMIndex.load(pipe_world["fa"] + ".bwt")
    jalns = j_align_device(jidx, JDI.from_fmindex(jidx),
                           j_read_fastq(pipe_world["fq"]),
                           JParams(max_diff=2, batch_size=128),
                           JConfig(cap=4096, acap=24), d_cap=32,
                           deep_tiers=False)
    assert got == b"".join(j_encode(a) for a in jalns)


def test_fixed_pipeline_short_batch_and_deep_tier(pipe_world, no_native):
    """Fewer reads than `batch_size` (one launch of exactly the reads given,
    whatever `queued` says), an arena so small that reads fail the first
    tier, and the deep tier of 256 lanes that resolves them."""
    stats: dict = {}
    got = run_port(pipe_world, AlnParams(max_diff=2, batch_size=512),
                   EngineConfig(cap=23 * 8 + 1, acap=24), stats, queued=True)
    assert got == pipe_world["gold"]
    first, deep = stats["tiers"]
    assert first["reads"] == N_READS and first["failed"] > 0
    assert deep["reads"] == first["failed"] == stats["retried_reads"]
    assert deep["cap"] > 100_000 and deep["failed"] < first["failed"]
    assert stats["launches"] == 2


def test_fixed_pipeline_with_native_library(pipe_world, native_lib,
                                            monkeypatch):
    """With the native library the gold pool runs beside the launches and
    takes the pre-routed slice; at d_cap 3 on this world the probe hands
    the D pass to the native scanner, so the streamed scan-and-launch
    branch runs."""
    monkeypatch.setattr(t_native, "_native", native_lib)
    monkeypatch.setattr(t_native, "_tried", True)
    params = AlnParams(max_diff=2, batch_size=128, n_threads=2)
    stats: dict = {}
    assert run_port(pipe_world, params, EngineConfig(cap=4096, acap=24),
                    stats) == pipe_world["gold"]
    assert stats["launches"] >= 2 and stats["prerouted"] > 0
    assert not stats.get("streamed")

    didx = TDI.from_fmindex(pipe_world["idx"], device="cpu")
    stats = {}
    alns = align_reads_device(pipe_world["idx"], didx, pipe_world["reads"],
                              params, EngineConfig(cap=4096, acap=24),
                              d_cap=3, stats=stats, device="cpu")
    assert b"".join(encode_alns(a) for a in alns) == pipe_world["gold"]
    assert stats.get("streamed") and stats["launches"] >= 2
