"""What the search kernel's wrapper (bwbble_tpu_torch/engine/kernel.py)
decides on the host, checked on the CPU: the shared memory a launch asks
for, and how a search launch is timed.  No CUDA device is needed: sizing
happens before any launch, and on CPU tensors the timer keeps the host
clock."""

import dataclasses

import numpy as np
import pytest
import torch

from bwbble_tpu_torch import worlds
from bwbble_tpu_torch.align.params import AlnParams
from bwbble_tpu_torch.engine import kernel, pipeline
from bwbble_tpu_torch.engine.device_index import from_fmindex
from bwbble_tpu_torch.engine.inexact import (EngineConfig, inexact_search,
                                             ring_statics)
from bwbble_tpu_torch.engine.pipeline import (LADDER, _LaunchTimer,
                                              align_reads_device,
                                              deep_tier_cfg)
from bwbble_tpu_torch.formats.fasta import fasta2ref
from bwbble_tpu_torch.formats.fastq import read_fastq
from bwbble_tpu_torch.index.fmindex import FMIndex
from bwbble_tpu_torch.testutil import random_genome_fasta, simulate_reads_fastq

torch.set_num_threads(1)

# the read length of the main, fixed, int64, easy, single and pre paths
# (100 bp reads), and D_seed's rows (seed_length + 1)
L100, DS = 100, 33
P4 = AlnParams(max_diff=4)
P3 = AlnParams(max_diff=3, batch_size=128)
P3S = dataclasses.replace(P3, precalc_len=4, use_precalc=True)
PW = AlnParams(max_diff=3, batch_size=128, mm_score=30, gapo_score=40,
               gape_score=20)
PS = AlnParams(max_diff=3, batch_size=128, is_multiref=False)
CFG_S = EngineConfig(cap=4096, acap=24, kx=2, max_iters=20_000, xcap=128)
CFG_TIER1 = EngineConfig(cap=32768, xcap=128)


def _small_lmax() -> int:
    return max(worlds.mixed_world()[1].max_len,
               worlds.single_genome_world()[1].max_len)


def chip_smoke_configs():
    """(name, params, cfg, Lmax, DS, lanes or None, seed slots, int64) of
    every launch configuration chip_smoke.py runs."""
    lm = _small_lmax()
    deep = deep_tier_cfg(CFG_TIER1, 2048, LADDER[0][0], LADDER[0][1])
    out = [
        # small worlds: ring and fixed, seeded (8 slots), 340 buckets, the
        # 4-letter alphabet (kx = 4 lists), the int64 instantiations
        ("mixed ring", P3, CFG_S, lm, 33, 64, 0, False),
        ("mixed fixed", P3, CFG_S, lm, 33, None, 0, False),
        ("mixed seeded", P3S, CFG_S, lm, 33, 16, 8, False),
        ("mixed wide scores", PW, CFG_S, lm, 33, 16, 0, False),
        ("iupac dense", P3, dataclasses.replace(CFG_S, cap=8192), lm, 33,
         32, 0, False),
        ("single", PS, EngineConfig(cap=4096, kx=4), lm, 33, 16, 0, False),
        ("single i64", PS, EngineConfig(cap=4096, kx=4), lm, 33, None, 0,
         True),
        ("mixed i64 seeded", P3S, CFG_S, lm, 33, None, 8, True),
        # main path: 512 lanes, then the deep rung's 128 lanes at acap 64
        ("main", P4, EngineConfig(cap=655360, kx=2, xcap=128), L100, DS,
         512, 0, False),
        ("main deep", P4, EngineConfig(cap=131072, acap=64, kx=2, xcap=128),
         L100, DS, 128, 0, False),
        # fixed and int64 paths: tier 1 (2 048 lanes), the deep tier
        ("fixed tier 1", P4, CFG_TIER1, L100, DS, None, 0, False),
        ("fixed deep", P4, deep, L100, DS, None, 0, False),
        ("int64 tier 1", P4, CFG_TIER1, L100, DS, None, 0, True),
        ("int64 deep", P4, deep, L100, DS, None, 0, True),
        # easy, single and pre paths: batches of 8 192 (32 seed slots)
        ("easy", P4, EngineConfig(cap=32768, kx=2, xcap=128), L100, DS,
         None, 0, False),
        ("easy single", dataclasses.replace(P4, is_multiref=False),
         EngineConfig(cap=32768, kx=2), L100, DS, None, 0, False),
        ("pre", dataclasses.replace(P4, precalc_len=12, use_precalc=True),
         EngineConfig(cap=32768, kx=2, xcap=128), L100, DS, None, 32,
         False),
        ("pre queued", dataclasses.replace(P4, precalc_len=12,
                                           use_precalc=True),
         EngineConfig(cap=32768, kx=2, xcap=128), L100, DS, 512, 32, False),
        # the virtual-offset index: reads of 1-3 bases, lists of 16
        ("virtual offset", AlnParams(max_diff=1),
         EngineConfig(cap=8192, kx=2, xcap=16), 3, 33, None, 0, True),
    ]
    return out


def _raw_bytes(S) -> int:
    """The bytes of the arrays a lane keeps in shared memory, unpadded (the
    frames' parents on the int32 layout when a read has at most PAR_MAX
    frames)."""
    it = 8 if S.x64 else 4
    npar = S.NFRAME if not S.x64 and S.NFRAME <= kernel.PAR_MAX else 0
    return (17 * it + (S.Lmax + 1) * 2 * it + S.DS * 2 * it
            + 4 * S.XC * it + 4 * S.NB + S.Lmax + 4 * npar)


@pytest.mark.parametrize("conf", chip_smoke_configs(), ids=lambda c: c[0])
def test_shared_memory_covers_every_chip_smoke_configuration(conf):
    _name, p, cfg, lmax, ds, lanes, slots, x64 = conf
    S = ring_statics(p, cfg, lmax, ds, fixed=lanes is None,
                     seed_slots=slots, x64=x64)
    smem = kernel.block_smem_bytes(S)
    lane = kernel.lane_smem_bytes(S)
    assert _raw_bytes(S) <= lane < _raw_bytes(S) + 7 * 16
    assert lane % 16 == 0
    assert smem == lane <= kernel.SMEM_MAX


def test_over_size_configuration_raises_before_any_launch():
    """A lane whose shared memory exceeds a block's 227 KB is refused with
    ValueError by the sizing, before any device check or launch."""
    S = ring_statics(P4, EngineConfig(cap=32768, xcap=8000), L100, DS,
                     fixed=True, x64=True)
    assert kernel.lane_smem_bytes(S) > kernel.SMEM_MAX
    with pytest.raises(ValueError, match="shared memory"):
        kernel.block_smem_bytes(S)
    # the largest list that fits a block is taken
    S1 = ring_statics(P4, EngineConfig(cap=32768, xcap=4000), L100, DS,
                      fixed=True, x64=True)
    lane = kernel.lane_smem_bytes(S1)
    assert lane <= kernel.SMEM_MAX < 2 * lane
    assert kernel.block_smem_bytes(S1) == lane
    idx, reads = worlds.mixed_world(n_reads=4)
    d64 = from_fmindex(idx, use_int64=True, device="cpu")
    rc = torch.from_numpy(np.asarray(reads.rc, dtype=np.int8))
    ln = torch.from_numpy(reads.lengths.astype(np.int32))
    D = torch.zeros((reads.count, reads.max_len + 1, 2), dtype=torch.int64)
    Ds = torch.zeros((reads.count, DS, 2), dtype=torch.int64)
    before = dict(kernel.LAUNCHES)
    with pytest.raises(ValueError, match="shared memory"):
        kernel.fixed_search(d64, rc, ln, D, Ds, P4,
                            EngineConfig(cap=4096, xcap=8000))
    assert kernel.LAUNCHES == before


class _Clock:
    """A host clock that advances one second at every reading."""

    def __init__(self):
        self.now = 0

    def time_ns(self) -> int:
        self.now += 10**9
        return self.now


def test_launch_timer_keeps_the_host_clock_on_the_cpu(monkeypatch,
                                                      tmp_path):
    """On CPU tensors the search runs the plain version and the timer keeps
    the host clock: no events are set, and `t_search` is host seconds (with
    a clock that advances a second a reading, at least one a launch)."""
    fa, fq = str(tmp_path / "w.fa"), str(tmp_path / "w.fq")
    random_genome_fasta(fa, {"21": 24_000}, seed=21, iupac_frac=0.003)
    simulate_reads_fastq(fa, fq, 16, read_len=36, mm_poisson=1.0, mm_cap=2,
                         seed=22)
    codes, _ = fasta2ref(fa, fa + ".ref", fa + ".ann")
    idx = FMIndex.build(codes)
    reads = read_fastq(fq)
    didx = from_fmindex(idx, device="cpu")
    p = AlnParams(max_diff=2, batch_size=8)
    ln = reads.lengths.astype(np.int32)
    D = np.zeros((reads.count, reads.max_len + 1, 2), dtype=np.int32)
    Ds = np.zeros((reads.count, DS, 2), dtype=np.int32)
    timer = _LaunchTimer(torch.device("cpu"))
    inexact_search(didx, np.asarray(reads.rc, dtype=np.int8), ln, D, Ds, p,
                   EngineConfig(cap=1024, xcap=16), device="cpu",
                   timer=timer)
    timer.stop()
    assert timer.events is None and timer.seconds() > 0.0
    # a CUDA launch must hand its events over: without them it raises
    with pytest.raises(RuntimeError, match="no events"):
        _LaunchTimer(torch.device("cuda")).seconds()
    monkeypatch.setattr(pipeline, "_tm", _Clock())
    for queued in (False, True):
        st: dict = {}
        align_reads_device(idx, didx, reads, p, EngineConfig(cap=4096),
                           stats=st, queued=queued, device="cpu")
        launches = st.get("launches", len(st.get("tiers") or []))
        assert launches > 0
        assert st["t_search"] >= launches
