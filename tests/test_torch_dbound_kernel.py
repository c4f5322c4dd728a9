"""The single-genome D-bound kernel (`dbound_1to1`, csrc/ring_search.cu) on
the CPU: its source compiled with g++ against csrc/warp_emu.h (the
`emu_lib` fixture of tests/test_torch_kernel_emulated.py) and launched
through the C entry the wrapper calls, held against its plain version
(engine/dbound.py:calc_d_1to1_chunk, calc_d_1to1 twice) on D, D_seed and
the overflow flags, tolerance zero, in every layout the fixed search takes;
then the wrapper's choice of path, its refusals and the `kernel` attribute
of a `dbounds.device` span, and a whole `-S` alignment whose D passes run
through the emulated kernel."""

import numpy as np
import pytest
import torch

from bwbble_tpu_torch import worlds
from bwbble_tpu_torch.align.params import AlnParams
from bwbble_tpu_torch.engine import dbound, dpass, kernel, pipeline
from bwbble_tpu_torch.engine.device_index import BLK, from_fmindex
from bwbble_tpu_torch.engine.inexact import EngineConfig
from bwbble_tpu_torch.formats.aln import encode_alns
from bwbble_tpu_torch.parallel import make_mesh
from test_torch_kernel_emulated import emu_lib  # noqa: F401

torch.set_num_threads(1)

CPU8 = [torch.device("cpu")] * 8
READ_LEN = 48
# read lengths around the seed lengths of CASES: 0, below, equal, one above,
# full width; the other reads keep READ_LEN
LENGTHS = [0, 1, 5, 11, 12, 13, 31, 32, 33, 47]

# (name, int64, tp, seed_len)
CASES = [
    ("int32 seed 12", False, 1, 12),
    ("int32 seed 32", False, 1, 32),
    ("int32 unseeded", False, 1, 0),
    ("int32 seed at full width", False, 1, READ_LEN),
    ("int64 seed 12", True, 1, 12),
    ("int64 seed 32", True, 1, 32),
    ("int32 tp 2 seed 32", False, 2, 32),
    ("int64 tp 3 seed 12", True, 3, 12),
]


def _reads():
    """The single-genome world's reads with the lengths of LENGTHS, Ns
    (code 4, a code past it, one at a read's first base) and a negative
    code, which the plain version clamps to A."""
    idx, rd = worlds.single_genome_world(n_reads=40, read_len=READ_LEN)
    seq = np.asarray(rd.seq, dtype=np.int8).copy()
    lengths = rd.lengths.astype(np.int32).copy()
    lengths[:len(LENGTHS)] = LENGTHS
    seq[12, 20] = 4
    seq[13, 0] = 4
    seq[14, 30] = 9
    seq[14, 31] = 4
    seq[15, 2] = -2
    return idx, torch.from_numpy(seq), torch.from_numpy(lengths)


def _emulated(lib, didx, seq, lengths, seed_len):
    """kernel.dbound_1to1's launch on CPU tensors, through the emulated
    build; the outputs start as garbage, so every word must be written."""
    D, Ds, ov = kernel.dbound_outputs(seq.shape[0], seq.shape[1], seed_len,
                                      didx.idt, "cpu")
    D.fill_(-7)
    Ds.fill_(-7)
    ov.fill_(True)
    rc = kernel.dbound_call(lib, didx, seq, lengths, seed_len, D, Ds, ov,
                            None)
    assert rc == 0
    return D, Ds, ov


def _rank_queries(monkeypatch, didx, seq, lengths):
    """The positions the plain D pass ranks at, over its active lanes."""
    real = dbound.rank1_pair
    seen = []

    def spy(d, c, iL, iU):
        seen.append((iL.clone(), iU.clone()))
        return real(d, c, iL, iU)

    monkeypatch.setattr(dbound, "rank1_pair", spy)
    dbound.calc_d_1to1(didx, seq, lengths, device="cpu")
    monkeypatch.setattr(dbound, "rank1_pair", real)
    return torch.cat([torch.cat([iL[lengths - 1 - s >= 0],
                                 iU[lengths - 1 - s >= 0]])
                      for s, (iL, iU) in enumerate(seen)])


@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_emulated_dbound_equals_plain_version(emu_lib, case, monkeypatch):
    _name, x64, tp, seed_len = case
    idx, seq, lengths = _reads()
    didx = from_fmindex(idx, use_int64=x64, device="cpu")
    if tp > 1:
        didx = make_mesh(1, tp, devices=CPU8).place(didx)[0]
        assert len(didx.tp_tables) == tp
    ref = dbound.calc_d_1to1_chunk(didx, seq, lengths, seed_len)
    got = _emulated(emu_lib, didx, seq, lengths, seed_len)
    for r, g in zip(ref, got):
        assert r.dtype == g.dtype and r.shape == g.shape
        assert torch.equal(r, g)
    assert ref[0].dtype == (torch.int64 if x64 else torch.int32)
    assert not ref[2].any()
    # the reads reach rank's edges: i == -1, i == length - 1, and the last
    # block, whose positions are clamped to length - 2
    q = _rank_queries(monkeypatch, didx, seq, lengths)
    n = int(didx.length)
    assert (q == -1).any() and (q == n - 1).any()
    assert ((q >= (n - 2) // BLK * BLK) & (q < n - 1)).any()
    # the cases reach what they are named for: reads with and without a
    # D_seed, misses (N) counted
    seeded = (lengths > seed_len) & (seed_len > 0)
    assert bool(seeded.any()) == (0 < seed_len < READ_LEN)
    assert not ref[1][~seeded].any()
    # read 12's N at position 20 is step 27: a miss, the whole range
    assert ref[0][12, 27, 0] == ref[0][12, 26, 0] + 1
    assert ref[0][12, 27, 1] == n


def test_cpu_index_takes_the_plain_version(monkeypatch):
    """On the CPU the plain version runs and nothing is launched; the
    chunk's bounds are dpass.chunk_bounds's single-genome result."""
    def boom(*a, **k):
        raise AssertionError("kernel wrapper called for a CPU index")

    monkeypatch.setattr(kernel, "dbound_1to1", boom)
    idx, seq, lengths = _reads()
    didx = from_fmindex(idx, device="cpu")
    before = dict(kernel.LAUNCHES)
    p = AlnParams(max_diff=2, is_multiref=False, seed_length=12)
    D, Ds, ov = dpass.chunk_bounds(didx, seq.numpy(), lengths.numpy(), p,
                                   16)
    assert kernel.LAUNCHES == before
    D1, _ = dbound.calc_d_1to1(didx, seq, lengths, device="cpu")
    assert torch.equal(D, D1) and not ov.any()
    use = lengths > 12
    Ds1, _ = dbound.calc_d_1to1(didx, seq, torch.where(use, 12, 0),
                                max_len=12, device="cpu")
    assert torch.equal(Ds[use], Ds1[use]) and not Ds[~use].any()


def test_c_entry_refusals_raise_and_count_nothing(emu_lib):
    """The C entry returns -1 for what it does not take (no read, no row,
    a table too short for the length, an int32 index past 2^31); the
    wrapper's count raises for any nonzero return and counts no launch."""
    idx, seq, lengths = _reads()
    didx = from_fmindex(idx, device="cpu")
    D, Ds, ov = kernel.dbound_outputs(40, READ_LEN, 12, torch.int32, "cpu")
    ptrs, tp, nloc = kernel.shard_args(didx)
    args = dict(x64=0, shards=ptrs.ctypes.data, tp=tp, nloc=nloc,
                len=int(didx.length), carr=didx.Carr.data_ptr(),
                seq=seq.data_ptr(), lens=lengths.data_ptr(), B=40,
                Lmax=READ_LEN, seed_len=12, D=D.data_ptr(),
                Ds=Ds.data_ptr(), ov=ov.data_ptr(), stream=None)
    assert emu_lib.dbound_1to1_launch(*args.values()) == 0
    for bad in (dict(B=0), dict(Lmax=0), dict(nloc=nloc - 1),
                dict(tp=0), dict(tp=kernel.MAX_TP + 1), dict(len=2**31),
                dict(shards=None)):
        assert emu_lib.dbound_1to1_launch(
            *{**args, **bad}.values()) == -1, bad
    before = dict(kernel.LAUNCHES)
    for rc in (-1, 700):
        with pytest.raises(RuntimeError, match=f"CUDA error {rc}"):
            kernel.count_launch(kernel.LAUNCHES, "dbound_1to1", rc)
    assert kernel.LAUNCHES == before


def test_wrapper_refuses_cpu_tensors():
    idx, seq, lengths = _reads()
    for x64 in (False, True):
        didx = from_fmindex(idx, use_int64=x64, device="cpu")
        before = dict(kernel.LAUNCHES)
        with pytest.raises(ValueError, match="CUDA"):
            kernel.dbound_1to1(didx, seq, lengths, 12)
        assert kernel.LAUNCHES == before


def _align_single(stats=None):
    idx, rd = worlds.single_genome_world(n_reads=40, read_len=36)
    didx = from_fmindex(idx, device="cpu")
    p = AlnParams(max_diff=2, batch_size=16, is_multiref=False,
                  seed_length=20)
    alns = pipeline.align_reads_device(
        idx, didx, rd, p, EngineConfig(cap=4096, acap=24), d_cap=16,
        stats=stats, device="cpu")
    return b"".join(encode_alns(a) for a in alns)


def test_alignment_through_the_emulated_kernel(emu_lib, monkeypatch):
    """A `-S` call whose D chunks launch the emulated kernel (40 reads in
    chunks of 16: three launches, each counted as kernel.dbound_1to1
    counts it) writes the plain D pass's `.aln` bytes, and its
    `dbounds.device` span says it launched the kernel; the plain call's
    span says it did not."""
    plain_stats: dict = {}
    plain = _align_single(plain_stats)

    def chunk(didx, seq, lengths, seed_len):
        D, Ds, ov = kernel.dbound_outputs(seq.shape[0], seq.shape[1],
                                          seed_len, didx.idt, "cpu")
        rc = kernel.dbound_call(emu_lib, didx, seq, lengths, seed_len, D,
                                Ds, ov, None)
        kernel.count_launch(kernel.LAUNCHES, "dbound_1to1", rc)
        return D, Ds, ov

    monkeypatch.setattr(dpass, "calc_d_1to1_chunk", chunk)
    stats: dict = {}
    n0 = kernel.LAUNCHES["dbound_1to1"]
    assert _align_single(stats) == plain
    assert kernel.LAUNCHES["dbound_1to1"] - n0 == 3
    for st, flag in ((plain_stats, 0), (stats, 1)):
        kernels = [s["kernel"] for s in st["spans"]
                   if s["name"] == "dbounds.device"]
        assert kernels == [flag]
    assert stats["launches"] > 0
