"""The port's multi-process runtime (`--dist`, parallel/distributed.py): two
CPU processes of `python -m bwbble_tpu_torch align --device cpu --dist ...`
align disjoint read shards, and the rank-0 merge is byte-equal to one
process, with the gold engine (as tests/test_distributed.py runs the JAX
package) and with the device engine on the CPU.  Tolerance: zero (bytes)."""

import os
import subprocess
import sys

import pytest

from bwbble_tpu_torch.formats.fasta import fasta2ref
from bwbble_tpu_torch.index import FMIndex
from bwbble_tpu_torch.testutil import random_genome_fasta, simulate_reads_fastq
from test_distributed import _free_port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("dist")
    fa, fq = str(d / "g.fa"), str(d / "r.fq")
    random_genome_fasta(fa, {"1": 40_000}, seed=9, iupac_frac=0.002)
    simulate_reads_fastq(fa, fq, 37, read_len=50, num_mm=2, seed=10)
    codes, _ = fasta2ref(fa, fa + ".ref", fa + ".ann")
    FMIndex.build(codes).store(fa + ".bwt")
    return d, fa, fq


def _env():
    env = dict(os.environ)
    env["OMP_NUM_THREADS"] = "1"
    return env


@pytest.mark.parametrize("engine", ["gold", "device"])
def test_two_process_merge_matches_single(world, engine):
    d, fa, fq = world
    args = ["align", "-n", "2", "--engine", engine, "--device", "cpu"]
    single = str(d / f"single_{engine}.aln")
    r = subprocess.run([sys.executable, "-m", "bwbble_tpu_torch", *args, fa,
                        fq, single], env=_env(), cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr

    # two coordinated processes, same command line except the rank
    dist = str(d / f"dist_{engine}.aln")
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "bwbble_tpu_torch", *args,
         "--dist", f"127.0.0.1:{port},2,{rank}", fa, fq, dist],
        env=_env(), cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for rank in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    for rank, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, out + err
        assert f"dist: process {rank}/2 aligning" in out
    with open(single, "rb") as f:
        a = f.read()
    with open(dist, "rb") as f:
        b = f.read()
    assert a and a == b
    assert not os.path.exists(dist + ".part0")
