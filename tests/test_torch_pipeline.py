"""The slice as a whole: the port's queued alignment pipeline and CLI on the
CPU against the JAX package's queued pipeline and the gold engine.  The
comparison is of `.aln` bytes: tolerance zero."""

import ctypes
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from bwbble_tpu.align.params import AlnParams as JParams
from bwbble_tpu.engine.device_index import from_fmindex as j_from_fmindex
from bwbble_tpu.engine.inexact import EngineConfig as JConfig
from bwbble_tpu.engine.pipeline import align_reads_device as j_align_device
from bwbble_tpu.formats.aln import encode_alns as j_encode
from bwbble_tpu.formats.fastq import read_fastq as j_read_fastq
from bwbble_tpu.index import FMIndex as JFMIndex

from bwbble_tpu_torch import native as t_native
from bwbble_tpu_torch.align.params import AlnParams
from bwbble_tpu_torch.align.pipeline import align_reads_gold
from bwbble_tpu_torch.engine.device_index import from_fmindex
from bwbble_tpu_torch.engine.inexact import EngineConfig
from bwbble_tpu_torch.engine.pipeline import align_reads_device
from bwbble_tpu_torch.formats.aln import encode_alns, write_aln_file
from bwbble_tpu_torch.formats.fasta import fasta2ref
from bwbble_tpu_torch.formats.fastq import read_fastq
from bwbble_tpu_torch.index import FMIndex
from bwbble_tpu_torch.testutil import (random_genome_fasta,
                                       simulate_reads_fastq)

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_READS = 160          # more than batch_size: the queued branch is taken


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("pipe")
    fa, fq = str(d / "w.fa"), str(d / "w.fq")
    random_genome_fasta(fa, {"21": 24_000}, seed=21, iupac_frac=0.003)
    simulate_reads_fastq(fa, fq, N_READS, read_len=36, mm_poisson=1.0,
                         mm_cap=2, indel_frac=0.1, max_indel=1, seed=22)
    codes, _ = fasta2ref(fa, fa + ".ref", fa + ".ann")
    idx = FMIndex.build(codes)
    idx.store(fa + ".bwt")
    reads = read_fastq(fq)
    params = AlnParams(max_diff=2, batch_size=128)
    gold = b"".join(encode_alns(a)
                    for a in align_reads_gold(idx, reads, params))
    return dict(dir=d, fa=fa, fq=fq, idx=idx, reads=reads, params=params,
                gold=gold)


@pytest.fixture
def no_native(monkeypatch):
    monkeypatch.setattr(t_native, "_native", None)
    monkeypatch.setattr(t_native, "_tried", True)


@pytest.fixture(scope="module")
def native_lib(tmp_path_factory):
    """The native C++ library built into a temporary directory (the shared
    native/build/ is left alone, so other tests see what they saw)."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the native library")
    out = str(tmp_path_factory.mktemp("native") / "libbwbble_native.so")
    subprocess.run(["g++", "-O2", "-std=c++17", "-shared", "-fPIC",
                    os.path.join(ROOT, "native", "bwbble_native.cpp"),
                    "-o", out], check=True)
    return t_native._Native(ctypes.CDLL(out))


def _run_port(world, stats):
    didx = from_fmindex(world["idx"], device="cpu")
    alns = align_reads_device(world["idx"], didx, world["reads"],
                              world["params"],
                              EngineConfig(cap=4096, acap=24), d_cap=32,
                              queued=True, qchunk=1, stats=stats,
                              device="cpu")
    return b"".join(encode_alns(a) for a in alns)


def test_queued_pipeline_bytes_equal_jax_and_gold(world, no_native):
    """Without the native library: D bounds come from the device calc_d and
    leftovers fall to the gold engine."""
    stats: dict = {}
    got = _run_port(world, stats)
    assert got == world["gold"]
    assert stats["launches"] >= 2 and stats["pops"] > 0
    assert stats["fallback_reads"] < N_READS // 2

    jidx = JFMIndex.load(world["fa"] + ".bwt")
    jalns = j_align_device(jidx, j_from_fmindex(jidx),
                           j_read_fastq(world["fq"]),
                           JParams(max_diff=2, batch_size=128),
                           JConfig(cap=4096, acap=24), d_cap=32,
                           queued=True, qchunk=1)
    assert got == b"".join(j_encode(a) for a in jalns)


def test_queued_pipeline_wide_score_range(world, no_native):
    """Scoring parameters that need several hundred score buckets (the
    device engine's domain goes to 1024, as in the JAX package) stay on the
    device path and give the gold engine's bytes; tolerance zero."""
    params = AlnParams(max_diff=2, batch_size=128, mm_score=30,
                       gapo_score=40, gape_score=20)
    didx = from_fmindex(world["idx"], device="cpu")
    stats: dict = {}
    alns = align_reads_device(world["idx"], didx, world["reads"], params,
                              EngineConfig(cap=4096, acap=24), d_cap=32,
                              queued=True, qchunk=1, stats=stats,
                              device="cpu")
    assert not stats.get("gold_routed") and stats["launches"] >= 1
    assert stats["fallback_reads"] < N_READS // 2
    gold = align_reads_gold(world["idx"], world["reads"], params)
    assert (b"".join(encode_alns(a) for a in alns)
            == b"".join(encode_alns(a) for a in gold))


def test_queued_pipeline_with_native_library(world, native_lib, monkeypatch):
    """With the native library: the probe may hand the D pass to the native
    scanner, and the gold pool runs beside the launches."""
    monkeypatch.setattr(t_native, "_native", native_lib)
    monkeypatch.setattr(t_native, "_tried", True)
    stats: dict = {}
    assert _run_port(world, stats) == world["gold"]
    assert stats["launches"] >= 1


def test_cli_index_align_equals_jax_gold_cli(world, tmp_path):
    fa = str(tmp_path / "c.fa")
    shutil.copy(world["fa"], fa)
    env = dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu")

    def run(*argv):
        r = subprocess.run([sys.executable, "-m", *argv], cwd=str(tmp_path),
                           env=env, capture_output=True, text=True,
                           timeout=600)
        assert r.returncode == 0, r.stdout + r.stderr

    run("bwbble_tpu_torch", "index", fa)
    with open(fa + ".bwt", "rb") as f, open(world["fa"] + ".bwt", "rb") as g:
        assert f.read() == g.read()
    run("bwbble_tpu_torch", "align", "-n", "2", "--queued", "--batch", "128",
        "--arena", "4096", "--device", "cpu", fa, world["fq"],
        str(tmp_path / "t.aln"))
    run("bwbble_tpu.cli", "align", "-n", "2", "--engine", "gold", fa,
        world["fq"], str(tmp_path / "j.aln"))
    with open(tmp_path / "t.aln", "rb") as f, \
            open(tmp_path / "j.aln", "rb") as g:
        data = f.read()
        assert data == g.read()
    assert data == world["gold"]
    # without --device cpu the port refuses to run where there is no card
    if not torch.cuda.is_available():
        r = subprocess.run(
            [sys.executable, "-m", "bwbble_tpu_torch", "align", "-n", "2",
             "--queued", "--batch", "128", fa, world["fq"],
             str(tmp_path / "x.aln")], cwd=str(tmp_path), env=env,
            capture_output=True, text=True, timeout=600)
        assert r.returncode != 0 and "CUDA" in r.stderr
