"""The D-bound kernels on the card (marker `card`; skips without a CUDA
device).  `dbound_1to1`: on the `microbe5m_single` world of portbench/ (a
4.6 Mbp pure-ACGT index) and a call's worth of its wgsim reads, the
kernel's D, D_seed and overflow flags equal the plain version's, tolerance
zero, in the int32 and int64 layouts and on a table range-sharded over two
members (one card named twice, and two cards where there are two); and one
`align_reads_device` call launches it once a chunk and writes the `.aln`
bytes of the plain D pass.  `dbound_mg`: on the `chr21_mg` world (a chr21
multi-genome) and the first 256 reads of a call, staged as the probe
stages them, at K = 2 and the cell's d_cap, the same equality in those
layouts, also with Ns planted; and one call on `chr21_mg`'s settings
launches it twice (the probe's two passes), its `dbounds.probe` span says
so, the probe's verdict is the plain version's and the `.aln` bytes are
the plain probe's.  Run on the card with
`python -m pytest --noconftest -m card tests/test_torch_dbound_card.py`
(tests/conftest.py imports JAX, which the card's machine does not need)."""

import os

import numpy as np
import pytest
import torch

from bwbble_tpu_torch import build_native, native
from bwbble_tpu_torch.align.params import AlnParams
from bwbble_tpu_torch.engine import dbound, dpass, kernel, pipeline
from bwbble_tpu_torch.engine.device_index import from_fmindex
from bwbble_tpu_torch.engine.inexact import EngineConfig
from bwbble_tpu_torch.formats.aln import encode_alns
from bwbble_tpu_torch.formats.fastq import parse_fastq_bytes
from bwbble_tpu_torch.index.fmindex import FMIndex
from bwbble_tpu_torch.parallel import make_mesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = "microbe5m_single.wgsim"
MG_CELL = "chr21_mg.wgsim"
SEED = 2_718_281_828
CHUNK = 8192
PROBE = 256


def _cell_world(name):
    """(FMIndex, the cell's settings, one call's reads), built into the
    benchmark's world cache."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernel runs on the card only")
    from portbench import cell as cell_mod
    from portbench import world as world_mod
    from portbench.gen import donor, reads as gen_reads
    root = os.path.join(ROOT, "portbench")
    cell = cell_mod.load(name, root)
    world = world_mod.ensure(cell.config["world"],
                             os.path.join(root, ".cache"))
    haps = donor.haplotypes(world, cell.traffic["donor"])
    pool = gen_reads.make_pool(haps, cell.traffic, SEED, 1,
                               int(cell.config["reads_per_call"]))
    reads = parse_fastq_bytes(pool[0].tobytes())
    return FMIndex.load(world.bwt, load_sa=False), cell.config, reads


@pytest.fixture(scope="module")
def card_world():
    return _cell_world(CELL)


@pytest.fixture(scope="module")
def mg_world():
    return _cell_world(MG_CELL)


def _chunk(reads, n):
    """The first n reads as calc_d_all stages a chunk."""
    seq = np.zeros((n, max(reads.max_len, 1)), dtype=np.int8)
    seq[:, :reads.seq.shape[1]] = reads.seq[:n]
    return seq, reads.lengths[:n].astype(np.int32)


@pytest.mark.card
def test_kernel_equals_plain_version_on_the_card(card_world):
    idx, config, reads = card_world
    seed_len = int(AlnParams(**config["align"]["params"]).seed_length)
    seq, ln = _chunk(reads, CHUNK)
    layouts = [(False, None), (True, None), (False, ["cuda:0"] * 2),
               (True, ["cuda:0"] * 2)]
    if torch.cuda.device_count() >= 2:
        layouts += [(False, ["cuda:0", "cuda:1"])]
    for x64, mesh_devs in layouts:
        didx = from_fmindex(idx, use_int64=x64, device="cuda:0")
        host = from_fmindex(idx, use_int64=x64, device="cpu")
        if mesh_devs is not None:
            didx = make_mesh(1, 2, devices=mesh_devs).place(didx)[0]
        before = dict(kernel.LAUNCHES)
        got = dbound.calc_d_1to1_chunk(
            didx, torch.from_numpy(seq).to(didx.device),
            torch.from_numpy(ln).to(didx.device), seed_len)
        torch.cuda.synchronize()
        entry = "dbound_1to1" + ("_tp" if mesh_devs else "") + (
            "_i64" if x64 else "")
        assert kernel.LAUNCHES[entry] == before[entry] + 1
        ref = dbound.calc_d_1to1_chunk_plain(host, torch.from_numpy(seq),
                                             torch.from_numpy(ln), seed_len)
        for r, g in zip(ref, got):
            assert r.dtype == g.dtype and torch.equal(r, g.cpu()), \
                (x64, mesh_devs)


@pytest.mark.card
def test_alignment_launches_once_a_chunk_and_equals_the_plain_pass(
        card_world, monkeypatch):
    idx, config, reads = card_world
    a = config["align"]
    params = AlnParams(**a["params"])
    assert not params.is_multiref and reads.count == 2 * params.batch_size
    didx = from_fmindex(idx, device="cuda", **a["index"])

    def call(stats):
        alns = pipeline.align_reads_device(
            idx, didx, reads, params, EngineConfig(**a["engine"]),
            stats=stats, **a["call"])
        return b"".join(encode_alns(x) for x in alns)

    n0 = kernel.LAUNCHES["dbound_1to1"]
    stats: dict = {}
    got = call(stats)
    assert kernel.LAUNCHES["dbound_1to1"] - n0 == 2
    assert [s["kernel"] for s in stats["spans"]
            if s["name"] == "dbounds.device"] == [1]
    monkeypatch.setattr(dpass, "calc_d_1to1_chunk",
                        dbound.calc_d_1to1_chunk_plain)
    n0 = kernel.LAUNCHES["dbound_1to1"]
    plain_stats: dict = {}
    assert call(plain_stats) == got
    assert kernel.LAUNCHES["dbound_1to1"] == n0
    assert [s["kernel"] for s in plain_stats["spans"]
            if s["name"] == "dbounds.device"] == [0]


def _layouts():
    out = [(False, None), (True, None), (False, ["cuda:0"] * 2)]
    if torch.cuda.device_count() >= 2:
        out += [(False, ["cuda:0", "cuda:1"])]
    return out


@pytest.mark.card
def test_mg_kernel_equals_plain_version_on_the_card(mg_world):
    idx, config, reads = mg_world
    a = config["align"]
    params = AlnParams(**a["params"])
    seed_len, d_cap = int(params.seed_length), int(a["call"]["d_cap"])
    seq, ln = _chunk(reads, PROBE)
    seq_n = seq.copy()
    seq_n[0, ln[0] // 2] = 4
    seq_n[1, 0] = 4
    overflow = {}
    for x64, mesh_devs in _layouts():
        didx = from_fmindex(idx, use_int64=x64, device="cuda:0")
        if mesh_devs is not None:
            didx = make_mesh(1, 2, devices=mesh_devs).place(didx)[0]
        entry = "dbound_mg" + ("_tp" if mesh_devs else "") + (
            "_i64" if x64 else "")
        for K in (2, d_cap):
            for sq in (seq, seq_n):
                sq_d = torch.from_numpy(sq).to(didx.device)
                ln_d = torch.from_numpy(ln).to(didx.device)
                before = kernel.LAUNCHES[entry]
                got = dbound.calc_d_chunk(didx, sq_d, ln_d, seed_len, K)
                torch.cuda.synchronize()
                assert kernel.LAUNCHES[entry] == before + 1
                ref = dbound.calc_d_chunk_plain(didx, sq_d, ln_d, seed_len,
                                                K)
                for r, g in zip(ref, got):
                    assert r.dtype == g.dtype and torch.equal(r, g), \
                        (x64, mesh_devs, K)
            overflow[K] = float(got[2].float().mean())
    # the probe's two passes on these reads: most lists overflow K = 2
    assert overflow[2] > 0.5


@pytest.mark.card
def test_mg_call_launches_twice_and_keeps_the_verdict(mg_world,
                                                      monkeypatch):
    idx, config, reads = mg_world
    a = config["align"]
    params = AlnParams(**a["params"])
    assert params.is_multiref
    didx = from_fmindex(idx, device="cuda", **a["index"])
    d_cap = int(a["call"]["d_cap"])
    # the native scanner, which the probe's second pass is for
    if native.get_native() is None:
        build_native.build(verbose=False)
        monkeypatch.setattr(native, "_tried", False)
    assert native.get_native() is not None

    def call(stats):
        alns = pipeline.align_reads_device(
            idx, didx, reads, params, EngineConfig(**a["engine"]),
            stats=stats, **a["call"])
        return b"".join(encode_alns(x) for x in alns)

    verdict = dpass.probe_native_d(didx, reads, params, d_cap,
                                   host_idx=idx)
    n0 = kernel.LAUNCHES["dbound_mg"]
    stats: dict = {}
    got = call(stats)
    assert kernel.LAUNCHES["dbound_mg"] - n0 == 2
    assert [s["kernel"] for s in stats["spans"]
            if s["name"] == "dbounds.probe"] == [1]
    monkeypatch.setattr(dpass, "calc_d_chunk", dbound.calc_d_chunk_plain)
    assert dpass.probe_native_d(didx, reads, params, d_cap,
                                host_idx=idx) == verdict == (d_cap, True)
    n0 = kernel.LAUNCHES["dbound_mg"]
    plain_stats: dict = {}
    assert call(plain_stats) == got
    assert kernel.LAUNCHES["dbound_mg"] == n0
    assert [s["kernel"] for s in plain_stats["spans"]
            if s["name"] == "dbounds.probe"] == [0]
