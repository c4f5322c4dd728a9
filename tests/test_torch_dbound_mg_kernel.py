"""The multi-genome D-bound kernel (`dbound_mg`, csrc/ring_search.cu) on the
CPU: its source compiled with g++ against csrc/warp_emu.h (the `emu_lib`
fixture of tests/test_torch_kernel_emulated.py) and launched through the C
entry the wrapper calls, held against its plain version
(engine/dbound.py:calc_d_chunk_plain, calc_d twice) on D, D_seed and the
overflow flags, tolerance zero: on an IUPAC-dense world whose lists overflow
at small K and on the mixed world, at K = 2, 7, 32, 33, 64 (and 256), in the
int32, int64 and tp = 2 layouts, with reads of length 0, 1, around the seed
length and full width, and reads with an N; one case also against the JAX
package's `_calc_d_chunk`.  Then the wrapper's refusals, the plain version
on a CPU index, and the pipeline through the emulated kernel: the probe's
verdict, a whole multi-genome call's `.aln` bytes, the `dbounds.probe`
span's `kernel` and the launch count."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bwbble_tpu.align.params import AlnParams as JParams
from bwbble_tpu.engine.pipeline import _calc_d_chunk as j_calc_d_chunk

from bwbble_tpu_torch import native as t_native
from bwbble_tpu_torch import worlds
from bwbble_tpu_torch.align.params import AlnParams
from bwbble_tpu_torch.engine import dbound, dpass, kernel, pipeline
from bwbble_tpu_torch.engine.device_index import from_fmindex
from bwbble_tpu_torch.engine.inexact import EngineConfig
from bwbble_tpu_torch.engine.spans import Spans
from bwbble_tpu_torch.formats.aln import encode_alns
from bwbble_tpu_torch.parallel import make_mesh
from test_torch_fixed import both_indexes
from test_torch_kernel_emulated import emu_lib  # noqa: F401
from test_torch_pipeline import native_lib  # noqa: F401

torch.set_num_threads(1)

CPU8 = [torch.device("cpu")] * 8
# the seed length a world's reads are cut around (the dense world's reads
# are 48 long and take the default 32; the mixed world's are 32 long)
SEED = {"dense": 32, "mixed": 12}


@pytest.fixture(scope="module")
def dense(tmp_path_factory):
    return worlds.iupac_dense_world(str(tmp_path_factory.mktemp("dense")),
                                    n_reads=24)


def _reads(world, dense_world):
    """A world's index and reads with the lengths 0, 1, seed - 1, seed,
    seed + 1, full - 1 and full width on its first reads, an N (code 4) in
    the middle of one read and at the first base of another, a code past
    N, and a negative code, which the plain version ranks as A."""
    idx, rd = dense_world if world == "dense" else worlds.mixed_world(
        n_reads=24)
    seq = np.asarray(rd.seq, dtype=np.int8).copy()
    lengths = rd.lengths.astype(np.int32).copy()
    full, s = seq.shape[1], SEED[world]
    lengths[:7] = [0, 1, s - 1, s, s + 1, full - 1, full]
    seq[8, full // 2] = 4
    seq[9, 0] = 4
    seq[10, 5] = 9
    seq[11, 3] = -2
    return idx, torch.from_numpy(seq), torch.from_numpy(lengths)


def _emulated(lib, didx, seq, lengths, seed_len, K):
    """kernel.dbound_mg's launch on CPU tensors, through the emulated
    build; the outputs start as garbage, so every word must be written."""
    D, Ds, ov = kernel.dbound_outputs(seq.shape[0], seq.shape[1], seed_len,
                                      didx.idt, "cpu")
    D.fill_(-7)
    Ds.fill_(-7)
    ov.fill_(True)
    rc = kernel.dbound_call(lib, didx, seq, lengths, seed_len, D, Ds, ov,
                            None, K)
    assert rc == 0
    return D, Ds, ov


def _index(idx, layout):
    didx = from_fmindex(idx, use_int64=layout == "int64", device="cpu")
    if layout == "tp 2":
        didx = make_mesh(1, 2, devices=CPU8).place(didx)[0]
        assert len(didx.tp_tables) == 2
    return didx


def _check_equal(ref, got):
    for r, g in zip(ref, got):
        assert r.dtype == g.dtype and r.shape == g.shape
        assert torch.equal(r, g)


# lists of a world's reads (the lengths and codes of _reads) overflow K at
# K <= lo for most reads, and never at K >= hi
LISTS = {"dense": (20, 32), "mixed": (64, 128)}

CASES = ([("dense", K, "int32") for K in (2, 7, 24, 32, 33, 64)]
         + [("mixed", K, "int32") for K in (2, 7, 32, 33, 64, 128, 256)]
         + [(w, K, lay) for lay in ("int64", "tp 2")
            for w, K in (("dense", 2), ("dense", 24), ("mixed", 33),
                         ("mixed", 128))])


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]} K {c[1]} "
                         f"{c[2]}")
def test_emulated_dbound_mg_equals_plain_version(emu_lib, dense, case):
    world, K, layout = case
    idx, seq, lengths = _reads(world, dense)
    didx = _index(idx, layout)
    seed_len = SEED[world]
    ref = dbound.calc_d_chunk_plain(didx, seq, lengths, seed_len, K)
    got = _emulated(emu_lib, didx, seq, lengths, seed_len, K)
    _check_equal(ref, got)
    assert ref[0].dtype == (torch.int64 if layout == "int64"
                            else torch.int32)
    # the cases reach what they are named for: reads with and without a
    # D_seed, an N counted as a miss at its step with the whole range's
    # width, lists that overflow a small K and fit a large one
    seeded = (lengths > seed_len) & (seed_len > 0)
    assert seeded.any() and (~seeded).any()
    assert not ref[1][~seeded].any()
    n = int(didx.length)
    st = int(lengths[8]) - 1 - seq.shape[1] // 2
    assert ref[0][8, st, 0] == ref[0][8, st - 1, 0] + 1
    assert ref[0][8, st, 1] == n
    lo, hi = LISTS[world]
    assert int(ref[2].sum()) > seq.shape[0] // 2 if K <= lo else True
    assert not ref[2].any() if K >= hi else True


def test_emulated_dbound_mg_equals_jax_package(emu_lib, dense):
    """The emulated kernel against the JAX package's _calc_d_chunk, on the
    dense world's reads with their Ns, at a K where some lists overflow."""
    idx, seq, lengths = _reads("dense", dense)
    seq = seq.clamp(min=0)
    jdx, tdx = both_indexes(idx)
    jp = JParams(max_diff=4, is_multiref=True, seed_length=32)
    ref = j_calc_d_chunk(jdx, jnp.asarray(seq.numpy()),
                         jnp.asarray(lengths.numpy()), lengths.numpy(), jp,
                         K=7)
    got = _emulated(emu_lib, tdx, seq, lengths, 32, 7)
    for r, g in zip(ref, got):
        assert np.array_equal(np.asarray(r), g.numpy())
    assert np.asarray(ref[2]).any() and not np.asarray(ref[2]).all()


def test_c_entry_refusals_raise_and_count_nothing(emu_lib, dense):
    """The C entry returns -1 for a K outside 1..DB_KMAX and for what
    dbound_1to1's entry refuses; it takes DB_KMAX, at least 256."""
    idx, seq, lengths = _reads("dense", dense)
    didx = from_fmindex(idx, device="cpu")
    B, Lmax = seq.shape
    D, Ds, ov = kernel.dbound_outputs(B, Lmax, 32, torch.int32, "cpu")
    ptrs, tp, nloc = kernel.shard_args(didx)
    args = dict(x64=0, shards=ptrs.ctypes.data, tp=tp, nloc=nloc,
                len=int(didx.length), carr=didx.Carr.data_ptr(),
                seq=seq.data_ptr(), lens=lengths.data_ptr(), B=B, Lmax=Lmax,
                seed_len=32, K=2, D=D.data_ptr(), Ds=Ds.data_ptr(),
                ov=ov.data_ptr(), stream=None)
    assert kernel.DB_KMAX >= 256
    for good in (dict(K=1), dict(K=kernel.DB_KMAX)):
        assert emu_lib.dbound_mg_launch(*{**args, **good}.values()) == 0
    for bad in (dict(K=0), dict(K=kernel.DB_KMAX + 1), dict(B=0),
                dict(Lmax=0), dict(nloc=nloc - 1), dict(tp=0),
                dict(tp=kernel.MAX_TP + 1), dict(len=2**31),
                dict(shards=None)):
        assert emu_lib.dbound_mg_launch(
            *{**args, **bad}.values()) == -1, bad


def test_wrapper_refuses_what_it_cannot_take(dense):
    idx, seq, lengths = _reads("dense", dense)
    before = dict(kernel.LAUNCHES)
    for x64 in (False, True):
        didx = from_fmindex(idx, use_int64=x64, device="cpu")
        with pytest.raises(ValueError, match="CUDA"):
            kernel.dbound_mg(didx, seq, lengths, 32, 64)
        for K in (0, kernel.DB_KMAX + 1):
            with pytest.raises(ValueError, match="list capacity"):
                kernel.dbound_mg(didx, seq, lengths, 32, K)
    assert kernel.LAUNCHES == before


def test_cpu_index_takes_the_plain_version(dense, monkeypatch):
    """On the CPU the plain version runs and nothing is launched; the
    chunk's bounds are calc_d twice, masked."""
    def boom(*a, **k):
        raise AssertionError("kernel wrapper called for a CPU index")

    monkeypatch.setattr(kernel, "dbound_mg", boom)
    idx, seq, lengths = _reads("dense", dense)
    didx = from_fmindex(idx, device="cpu")
    before = dict(kernel.LAUNCHES)
    p = AlnParams(max_diff=4, is_multiref=True, seed_length=32)
    D, Ds, ov = dpass.chunk_bounds(didx, seq.numpy(), lengths.numpy(), p,
                                   7)
    assert kernel.LAUNCHES == before
    D1, ov1 = dbound.calc_d(didx, seq, lengths, K=7, device="cpu")
    use = lengths > 32
    Ds1, ov2 = dbound.calc_d(didx, seq, torch.where(use, 32, 0), K=7,
                             max_len=32, device="cpu")
    assert torch.equal(D, D1) and torch.equal(Ds[use], Ds1[use])
    assert not Ds[~use].any() and torch.equal(ov, ov1 | (ov2 & use))


@pytest.fixture
def through_emulator(emu_lib, monkeypatch):
    """dpass.chunk_bounds's multi-genome chunks launch the emulated kernel, each
    counted as kernel.dbound_mg counts it; returns the list of their K."""
    made: list = []

    def chunk(didx, seq, lengths, seed_len, K):
        D, Ds, ov = kernel.dbound_outputs(seq.shape[0], seq.shape[1],
                                          seed_len, didx.idt, "cpu")
        rc = kernel.dbound_call(emu_lib, didx, seq, lengths, seed_len, D,
                                Ds, ov, None, K)
        kernel.count_launch(kernel.LAUNCHES, "dbound_mg", rc)
        made.append(K)
        return D, Ds, ov

    monkeypatch.setattr(dpass, "calc_d_chunk", chunk)
    return made


def _probe(dense, d_cap):
    idx, rd = dense
    stats: dict = {}
    out = dpass.probe_native_d(
        from_fmindex(idx, device="cpu"), rd,
        AlnParams(max_diff=4, is_multiref=True), d_cap, host_idx=idx,
        spans=Spans(stats))
    return out, stats["spans"]


@pytest.mark.parametrize("d_cap", [3, 64])
def test_probe_verdict_through_the_emulated_kernel(dense, native_lib,
                                                   monkeypatch, d_cap,
                                                   request):
    """The probe's (K1, skip) through the emulated kernel is the plain
    version's; its span says it launched, once a pass; the plain one's
    says it did not."""
    monkeypatch.setattr(t_native, "_native", native_lib)
    monkeypatch.setattr(t_native, "_tried", True)
    plain, plain_spans = _probe(dense, d_cap)
    made = request.getfixturevalue("through_emulator")
    n0 = kernel.LAUNCHES["dbound_mg"]
    got, spans = _probe(dense, d_cap)
    assert got == plain and made == [2, d_cap]
    assert kernel.LAUNCHES["dbound_mg"] - n0 == 2
    assert [s["kernel"] for s in plain_spans] == [0]
    assert [s["kernel"] for s in spans] == [1]
    assert got == ((d_cap, True) if d_cap == 3 else (d_cap, False))


def _align_mixed(stats=None):
    idx, rd = worlds.mixed_world(n_reads=40)
    p = AlnParams(max_diff=2, batch_size=16, is_multiref=True,
                  seed_length=12)
    alns = pipeline.align_reads_device(
        idx, from_fmindex(idx, device="cpu"), rd, p,
        EngineConfig(cap=4096, acap=24), d_cap=16, stats=stats,
        device="cpu")
    return b"".join(encode_alns(a) for a in alns)


def test_alignment_through_the_emulated_kernel(monkeypatch, request):
    """A multi-genome call without the native scanner, so that every D pass
    is a device pass, whose D chunks launch the emulated kernel (the probe,
    40 reads in chunks of 16, the retry of the overflowing reads) writes
    the plain D passes' `.aln` bytes; the launch count is the chunks made;
    every D span says it launched, and none of the plain call's."""
    monkeypatch.setattr(t_native, "_native", None)
    monkeypatch.setattr(t_native, "_tried", True)
    plain_stats: dict = {}
    plain = _align_mixed(plain_stats)
    made = request.getfixturevalue("through_emulator")
    stats: dict = {}
    n0 = kernel.LAUNCHES["dbound_mg"]
    assert _align_mixed(stats) == plain
    assert kernel.LAUNCHES["dbound_mg"] - n0 == len(made) >= 4
    for st, flag in ((plain_stats, 0), (stats, 1)):
        kernels = [s["kernel"] for s in st["spans"]
                   if s["name"] in ("dbounds.probe", "dbounds.device")]
        assert kernels and set(kernels) == {flag}
