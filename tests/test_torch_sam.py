"""Stage 3 of the port: batched SA resolution (`rank.sa_resolve`), `aln2sam`
and `eval`, against the JAX package and the host resolver, and the three
stages through the CLI as the quick start types them.  Integers and bytes:
the tolerance is zero."""

import os
import shutil
import subprocess
import sys

import numpy as np
import torch

import jax.numpy as jnp

from bwbble_tpu.align.evaluate import eval_alns as j_eval_alns
from bwbble_tpu.engine import rank as JR

from bwbble_tpu_torch import cli
from bwbble_tpu_torch.align.eval import pick_hits, resolve_sa_gold
from bwbble_tpu_torch.align.evaluate import eval_alns
from bwbble_tpu_torch.align.pipeline import alns_to_sam
from bwbble_tpu_torch.engine import rank as TR
from bwbble_tpu_torch.formats.aln import read_aln_file, write_aln_file
from bwbble_tpu_torch.formats.fasta import read_ann
from bwbble_tpu_torch.align.params import AlnParams
from bwbble_tpu_torch.align.pipeline import align_reads_gold
from bwbble_tpu_torch.index import FMIndex
from test_torch_fixed import N_READS, both_indexes, pipe_world  # noqa: F401

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_sa_resolve_equals_jax_and_host_resolver(pipe_world):
    idx = FMIndex.load(pipe_world["fa"] + ".bwt", load_sa=True)
    jdx, tdx = both_indexes(idx)
    rng = np.random.default_rng(9)
    rows = np.concatenate([rng.integers(0, idx.length, 300),
                           [0, 1, 31, 32, idx.sa0, idx.length - 1]]
                          ).astype(np.int32)
    got = TR.sa_resolve(tdx, torch.from_numpy(rows)).numpy()
    np.testing.assert_array_equal(
        np.asarray(JR.sa_resolve(jdx, jnp.asarray(rows))), got)
    np.testing.assert_array_equal(resolve_sa_gold(idx, rows), got)


def test_sam_positions_equal_host_resolver(pipe_world, tmp_path):
    """`alns_to_sam` with the device resolver gives the host resolver's SAM
    text, and the resolved rows are the host's positions."""
    w = pipe_world
    idx = FMIndex.load(w["fa"] + ".bwt", load_sa=True)
    aln = str(tmp_path / "g.aln")
    write_aln_file(aln, align_reads_gold(idx, w["reads"],
                                         AlnParams(max_diff=2)))
    per_read = read_aln_file(aln)
    resolver = cli.device_sa_resolver(idx, device="cpu")
    rows = np.array([h.aln_sa for h in map(pick_hits, per_read)
                     if h.aln_type != 0], dtype=np.int64)
    assert rows.size > N_READS // 2
    np.testing.assert_array_equal(resolver(rows), resolve_sa_gold(idx, rows))
    assert resolver(rows[:0]).shape == (0,)
    ann = read_ann(w["fa"] + ".ann")
    host = alns_to_sam(idx, ann, w["reads"], read_aln_file(aln))
    dev = alns_to_sam(idx, ann, w["reads"], read_aln_file(aln),
                      sa_resolver=resolver)
    assert dev == host and dev.count("\n") > N_READS


def test_eval_counters_equal_jax(pipe_world, tmp_path):
    w = pipe_world
    idx = FMIndex.load(w["fa"] + ".bwt", load_sa=True)
    aln = str(tmp_path / "g.aln")
    write_aln_file(aln, align_reads_gold(idx, w["reads"],
                                         AlnParams(max_diff=2)))
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    got = eval_alns(idx, w["reads"], read_aln_file(aln),
                    out_dir=str(tmp_path / "t"))
    ref = j_eval_alns(idx, w["reads"], read_aln_file(aln),
                      out_dir=str(tmp_path / "j"))
    assert got == ref and sum(v for v in got.values()
                              if isinstance(v, int)) > 0
    for name in sorted(os.listdir(tmp_path / "j")):
        assert (tmp_path / "t" / name).read_bytes() == \
            (tmp_path / "j" / name).read_bytes(), name


def test_cli_default_align_and_aln2sam_equal_jax_cli(pipe_world, tmp_path):
    """`index`, `align` as the quick start types it (no `--queued`),
    `aln2sam` and `eval` through the port's CLI against the JAX CLI's gold
    engine."""
    fa = str(tmp_path / "c.fa")
    shutil.copy(pipe_world["fa"], fa)
    env = dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu")

    def run(*argv, ok=True):
        r = subprocess.run([sys.executable, "-m", *argv], cwd=str(tmp_path),
                           env=env, capture_output=True, text=True,
                           timeout=600)
        assert (r.returncode == 0) == ok, r.stdout + r.stderr
        return r

    run("bwbble_tpu_torch", "index", fa)
    run("bwbble_tpu_torch", "align", "-n", "2", "--batch", "128",
        "--arena", "4096", "--device", "cpu", fa, pipe_world["fq"],
        str(tmp_path / "t.aln"))
    run("bwbble_tpu.cli", "align", "-n", "2", "--engine", "gold", fa,
        pipe_world["fq"], str(tmp_path / "j.aln"))
    assert (tmp_path / "t.aln").read_bytes() == pipe_world["gold"]
    assert (tmp_path / "j.aln").read_bytes() == pipe_world["gold"]
    run("bwbble_tpu_torch", "aln2sam", "--device", "cpu", fa,
        pipe_world["fq"], str(tmp_path / "t.aln"), str(tmp_path / "t.sam"))
    run("bwbble_tpu.cli", "aln2sam", fa, pipe_world["fq"],
        str(tmp_path / "j.aln"), str(tmp_path / "j.sam"))
    sam = (tmp_path / "t.sam").read_bytes()
    assert sam == (tmp_path / "j.sam").read_bytes()
    assert sam.count(b"\n") > N_READS
    r = run("bwbble_tpu_torch", "eval", fa, pipe_world["fq"],
            str(tmp_path / "t.aln"))
    assert "Alignment Evaluation" in r.stdout
    # without --device cpu neither carries on where there is no card
    if not torch.cuda.is_available():
        for argv in (("align", "-n", "2", fa, pipe_world["fq"],
                      str(tmp_path / "x.aln")),
                     ("aln2sam", fa, pipe_world["fq"],
                      str(tmp_path / "t.aln"), str(tmp_path / "x.sam"))):
            r = run("bwbble_tpu_torch", *argv, ok=False)
            assert "CUDA" in r.stderr
            assert not os.path.exists(argv[-1])
