"""The port imports neither jax nor the JAX package, and it never carries on
on the CPU by itself: with no CUDA device, entry points that are not told
`device="cpu"` raise."""

import os
import pkgutil
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import bwbble_tpu_torch
from bwbble_tpu_torch import cli, worlds
from bwbble_tpu_torch.align.params import AlnParams
from bwbble_tpu_torch.benchmarks import kernels as probes
from bwbble_tpu_torch.engine import kernel
from bwbble_tpu_torch.engine.dbound import calc_d
from bwbble_tpu_torch.engine.device_index import from_arrays, from_fmindex
from bwbble_tpu_torch.engine.inexact import (EngineConfig,
                                             inexact_search_queued)
from bwbble_tpu_torch.engine.pipeline import align_reads_device
from bwbble_tpu_torch.parallel import make_mesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _submodules():
    return sorted(m.name for m in pkgutil.walk_packages(
        bwbble_tpu_torch.__path__, "bwbble_tpu_torch."))


def test_importing_every_submodule_pulls_in_no_jax():
    """Nor the JAX package or its probes (`benchmarks`): the port's probes
    under bwbble_tpu_torch.benchmarks are its own."""
    mods = [m for m in _submodules() if not m.endswith("__main__")]
    assert len(mods) > 20
    assert {"bwbble_tpu_torch.benchmarks.kernels",
            "bwbble_tpu_torch.benchmarks.dma_probe",
            "bwbble_tpu_torch.benchmarks.gather_pallas_probe",
            "bwbble_tpu_torch.benchmarks.gather_bench",
            "bwbble_tpu_torch.parallel.shard",
            "bwbble_tpu_torch.parallel.distributed"} <= set(mods)
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'bwbble_tpu', 'benchmarks')]\n"
            "print('BAD', bad)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "BAD []" in r.stdout, r.stdout


def test_sources_name_neither_jax_nor_the_jax_package():
    pat = re.compile(
        r"^\s*(import|from)\s+(jax|bwbble_tpu|benchmarks)(\.|\s|$)", re.M)
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "bwbble_tpu_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    for path in files:
        with open(path) as f:
            assert not pat.search(f.read()), path


@pytest.fixture(scope="module")
def small():
    idx, reads = worlds.mixed_world(n_reads=8)
    return idx, reads


def test_default_device_raises_without_cuda(small):
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a CUDA device")
    idx, reads = small
    with pytest.raises(RuntimeError, match="CUDA"):
        from_fmindex(idx)
    didx = from_fmindex(idx, device="cpu")
    assert didx.table.device.type == "cpu"
    seq = np.asarray(reads.seq, dtype=np.int8)
    ln = reads.lengths.astype(np.int32)
    with pytest.raises(RuntimeError, match="CUDA"):
        calc_d(didx, seq, ln, K=2)
    D, _ = calc_d(didx, seq, ln, K=2, device="cpu")
    Ds = torch.zeros((reads.count, 33, 2), dtype=torch.int32)
    p = AlnParams(max_diff=1, batch_size=4)
    cfg = EngineConfig(cap=512)
    with pytest.raises(RuntimeError, match="CUDA"):
        inexact_search_queued(didx, np.asarray(reads.rc, dtype=np.int8), ln,
                              D, Ds, p, cfg, lanes=4)
    with pytest.raises(RuntimeError, match="CUDA"):
        align_reads_device(idx, didx, reads, p, cfg, queued=True)


def test_kernel_wrapper_never_runs_the_plain_version(small):
    """The kernels' wrappers launch or raise: given CPU tensors they refuse,
    seeded or not; they do not fall back."""
    idx, reads = small
    didx = from_fmindex(idx, device="cpu")
    ln = torch.from_numpy(reads.lengths.astype(np.int32))
    rc = torch.from_numpy(np.asarray(reads.rc, dtype=np.int8))
    D = torch.zeros((reads.count, reads.max_len + 1, 2), dtype=torch.int32)
    Ds = torch.zeros((reads.count, 33, 2), dtype=torch.int32)
    before = dict(kernel.LAUNCHES)
    assert set(before) == {"ring_search", "fixed_search",
                           "ring_search_seeded", "fixed_search_seeded",
                           "fixed_search_i64", "fixed_search_seeded_i64",
                           "fixed_search_tp", "fixed_search_seeded_tp",
                           "fixed_search_tp_i64",
                           "fixed_search_seeded_tp_i64", "dbound_1to1",
                           "dbound_1to1_i64", "dbound_1to1_tp",
                           "dbound_1to1_tp_i64", "dbound_mg",
                           "dbound_mg_i64", "dbound_mg_tp",
                           "dbound_mg_tp_i64"}
    seeds = (torch.zeros((reads.count, 4), dtype=torch.int32),
             torch.zeros((reads.count, 4), dtype=torch.int32),
             torch.ones((reads.count,), dtype=torch.int32))
    for multiref in (True, False):
        p = AlnParams(max_diff=1, is_multiref=multiref, precalc_len=4,
                      use_precalc=True)
        for sd in (None, seeds):
            with pytest.raises(ValueError, match="CUDA"):
                kernel.ring_search(didx, rc, ln, D, Ds, p,
                                   EngineConfig(cap=512), lanes=4, seeds=sd)
            with pytest.raises(ValueError, match="CUDA"):
                kernel.fixed_search(didx, rc, ln, D, Ds, p,
                                    EngineConfig(cap=512), seeds=sd)
    with pytest.raises(ValueError, match="CUDA"):
        kernel.dbound_1to1(didx, rc, ln, 32)
    with pytest.raises(ValueError, match="CUDA"):
        kernel.dbound_mg(didx, rc, ln, 32, 16)
    assert kernel.LAUNCHES == before


def test_probe_wrappers_never_run_the_plain_version_off_the_cpu(monkeypatch):
    """The probe wrappers run their plain version only for CPU tensors; a
    tensor elsewhere (here on the `meta` device) is refused before any
    launch, and the plain versions are not called."""
    before = dict(probes.LAUNCHES)
    assert set(before) == {"dma_wave", "digest_consume", "row_gather"}

    def boom(*a, **k):
        raise AssertionError("plain version called")

    for name in ("dma_wave_plain", "digest_consume_plain",
                 "row_gather_plain"):
        monkeypatch.setattr(probes, name, boom)
    meta = {"device": "meta", "dtype": torch.int32}
    calls = [
        lambda: probes.dma_wave(torch.empty((8, 4), **meta),
                                torch.empty((16, 128), **meta), 2),
        lambda: probes.digest_consume(torch.empty((6 * 32, 256), **meta),
                                      "lane_major", 6, 256),
        lambda: probes.row_gather(torch.empty((16, 32), **meta),
                                  torch.empty((8,), **meta)),
        lambda: probes.row_gather(torch.empty((16, 32), **meta),
                                  torch.empty((8,), **meta), "ring", nbuf=8),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="CUDA"):
            call()
    assert probes.LAUNCHES == before


def test_unported_paths_raise_not_implemented(small, tmp_path):
    """What the port does not run raises: a mesh with `-P` seeding (as in
    the JAX package), a ring launch on a range-sharded index and a table
    of more than 8 shards (the kernel's limits), and a queued search on the
    int64 layout (as in the JAX package).  (`-P` seeding is ported:
    tests/test_torch_precalc.py; a seed table without params.use_precalc,
    or the flag without a table, is refused.  Device meshes, tp > 1 on the
    card and `--dist` are ported: tests/test_torch_parallel.py,
    tests/test_torch_tp_kernel.py and tests/test_torch_distributed.py.)"""
    idx, reads = small
    didx = from_fmindex(idx, device="cpu")
    cfg = EngineConfig(cap=512)
    mesh = make_mesh(1, devices=["cpu"])
    for queued in (False, True):
        with pytest.raises(NotImplementedError, match="mesh"):
            align_reads_device(idx, didx, reads,
                               AlnParams(max_diff=1, use_precalc=True), cfg,
                               precalc=object(), queued=queued, mesh=mesh,
                               device="cpu")
        with pytest.raises(ValueError, match="use_precalc"):
            align_reads_device(idx, didx, reads,
                               AlnParams(max_diff=1, use_precalc=True), cfg,
                               queued=queued, device="cpu")
    # a sharded table: the kernel's wrapper refuses a ring launch on one,
    # and more shards than the kernel takes, before anything else
    sharded = make_mesh(1, 2, devices=["cpu"] * 2).place(didx)[0]
    ln = torch.from_numpy(reads.lengths.astype(np.int32))
    rc = torch.from_numpy(np.asarray(reads.rc, dtype=np.int8))
    D = torch.zeros((reads.count, reads.max_len + 1, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="ring launch takes no sharded"):
        kernel.ring_search(sharded, rc, ln, D, D, AlnParams(max_diff=1),
                           cfg, lanes=4)
    nine = make_mesh(1, 9, devices=["cpu"] * 9).place(didx)[0]
    with pytest.raises(ValueError, match="at most 8"):
        kernel.fixed_search(nine, rc, ln, D, D, AlnParams(max_diff=1), cfg)
    # the int64 whole-genome layout: 48-word rows are taken as int64, and
    # a queued search on them is refused
    d64 = from_arrays(np.zeros((4, 48), dtype=np.int32), np.zeros(17),
                      np.zeros(1), 400, 0, device="cpu")
    assert d64.idt == torch.int64 and d64.Carr.dtype == torch.int64
    with pytest.raises(NotImplementedError, match="int64"):
        inexact_search_queued(d64, np.zeros((4, 8), np.int8),
                              np.full(4, 8, np.int32),
                              np.zeros((4, 9, 2), np.int64),
                              np.zeros((4, 33, 2), np.int64),
                              AlnParams(max_diff=1), cfg, lanes=4,
                              device="cpu")
    # CLI: --mesh and --dist parse; with no input files the run stops at
    # the missing index, before the process group or the mesh is made
    for flag in (["--mesh", "1"], ["--mesh", "2,2"],
                 ["--dist", "localhost:1,1,0"]):
        with pytest.raises(FileNotFoundError, match="g.fa.bwt"):
            cli.main(["align", *flag, "--device", "cpu",
                      str(tmp_path / "g.fa"), "r.fq",
                      str(tmp_path / "o.aln")])
