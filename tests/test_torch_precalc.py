"""`-P` seeded search in the port against the JAX package and the gold
engine: the seed table (`align/precalc.py`: the device build, the `.pre`
codec), the seeded fixed and queued searches (the kernel module's plain
versions on the CPU), the seeded pipeline and the CLI.  All comparisons are
of integers and bytes: the tolerance is zero.

The worlds give reads several roots: on the mixed and the IUPAC-dense world
a short k-mer has many SA intervals, so a read's seed list runs to several
entries, and `seed_slots` is chosen below the longest lists so that some
reads overflow it.  What a fixed batch promises against the JAX batch is
the contract of tests/test_torch_fixed.py; the ring's per-read clock is
exact."""

import inspect
import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bwbble_tpu.align import precalc as JP
from bwbble_tpu.align.params import AlnParams as JParams
from bwbble_tpu.engine import device_index as JDI
from bwbble_tpu.engine.inexact import EngineConfig as JConfig
from bwbble_tpu.engine.inexact import inexact_search as j_fixed
from bwbble_tpu.engine.inexact import inexact_search_queued as j_queued
from bwbble_tpu.engine.inexact import unpack_paths as j_unpack
from bwbble_tpu.engine.inexact import walk_paths as j_walk
from bwbble_tpu.engine.pipeline import _calc_d_chunk as j_calc_d_chunk
from bwbble_tpu.engine.pipeline import align_reads_device as j_align_device
from bwbble_tpu.formats.aln import encode_alns as j_encode
from bwbble_tpu.formats.fastq import read_fastq as j_read_fastq
from bwbble_tpu.index import FMIndex as JFMIndex

from bwbble_tpu_torch import cli
from bwbble_tpu_torch import native as t_native
from bwbble_tpu_torch import worlds
from bwbble_tpu_torch.align import precalc as TP
from bwbble_tpu_torch.align.params import AlnParams
from bwbble_tpu_torch.align.pipeline import align_reads_gold
from bwbble_tpu_torch.engine import device_index as TDI
from bwbble_tpu_torch.engine.inexact import (EngineConfig, inexact_search,
                                             inexact_search_queued,
                                             unpack_paths, walk_paths)
from bwbble_tpu_torch.engine.pipeline import _lookup_seeds, align_reads_device
from bwbble_tpu_torch.formats.aln import encode_alns, read_aln_file
from bwbble_tpu_torch.gold.engine import exact_match
from test_torch_fixed import PER_READ, as_numpy, both_indexes
from test_torch_fixed import pipe_world  # noqa: F401
from test_torch_pipeline import native_lib  # noqa: F401

torch.set_num_threads(1)

# every function the port copies from bwbble_tpu/align/precalc.py; only the
# package name differs (load_or_build_precalc also takes `device`)
COPIED = ["PrecalcTable", "read_indices", "_compact", "_finalize",
          "_fix_overflow", "store_pre", "load_pre", "build_precalc_gold",
          "load_or_build_precalc"]
DEVICE_ARG = [
    ('engine: str = "device"\n                          ) -> PrecalcTable:',
     'engine: str = "device",\n                          device=None) '
     '-> PrecalcTable:'),
    ("build_precalc_device(idx, from_fmindex(idx), params, k=k)",
     "build_precalc_device(idx,\n"
     "                                         from_fmindex(idx, device=device),"
     "\n                                         params, k=k, device=device)"),
]


@pytest.mark.parametrize("name", COPIED)
def test_copied_precalc_function_differs_only_in_package_name(name):
    orig = re.sub(r"\bbwbble_tpu\b", "bwbble_tpu_torch",
                  inspect.getsource(getattr(JP, name)))
    if name == "load_or_build_precalc":
        for old, new in DEVICE_ARG:
            assert old in orig
            orig = orig.replace(old, new)
    assert inspect.getsource(getattr(TP, name)) == orig


# ------------------------------------------------------------- seed table

@pytest.fixture(scope="module")
def small_worlds(tmp_path_factory):
    mixed = worlds.mixed_world()
    dense = worlds.iupac_dense_world(str(tmp_path_factory.mktemp("dense")))
    out = {}
    for name, (idx, reads) in (("mixed", mixed), ("dense", dense)):
        jdx, tdx = both_indexes(idx)
        out[name] = dict(idx=idx, reads=reads, jdx=jdx, tdx=tdx)
    return out


def _table_equal(a, b):
    for k in ("cnt", "off", "L", "U"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k),
                                      err_msg=k)


@pytest.mark.parametrize("world,K,level", [("mixed", 16, 2), ("mixed", 2, 3),
                                           ("dense", 4, 2)])
def test_build_precalc_device_equals_jax_and_gold(small_worlds, world, K,
                                                  level):
    """The port's level-wise build (levels on the device, lead chunks past
    `max_level_full`) gives the JAX build's and the gold build's cnt, off,
    L and U at precalc_len 4.  On these worlds a 4-mer has up to 96
    intervals, so entries overflow the list capacity K and `_fix_overflow`
    recomputes them, at K = 2 for most entries."""
    w = small_worlds[world]
    k = 4
    got = TP.build_precalc_device(w["idx"], w["tdx"], AlnParams(precalc_len=k),
                                  k=k, K=K, max_level_full=level,
                                  sub_batch=64, device="cpu")
    ref = JP.build_precalc_device(w["idx"], w["jdx"], JParams(precalc_len=k),
                                  k=k, K=K, max_level_full=level,
                                  sub_batch=64)
    _table_equal(got, ref)
    _table_equal(got, TP.build_precalc_gold(w["idx"], AlnParams(), k=k))
    assert (got.cnt > K).any(), "K does not force a recompute"


def test_store_pre_bytes_round_trip_and_read_indices(small_worlds, tmp_path):
    w = small_worlds["dense"]
    k = 5
    table = TP.build_precalc_device(w["idx"], w["tdx"], AlnParams(), k=k,
                                    K=16, max_level_full=3, sub_batch=256,
                                    device="cpu")
    TP.store_pre(str(tmp_path / "t.pre"), table)
    JP.store_pre(str(tmp_path / "j.pre"), table)
    with open(tmp_path / "t.pre", "rb") as f, \
            open(tmp_path / "j.pre", "rb") as g:
        assert f.read() == g.read()
    _table_equal(TP.load_pre(str(tmp_path / "t.pre"), num_entries=4 ** k),
                 table)
    rc = np.asarray(w["reads"].rc, dtype=np.int8)
    ln = w["reads"].lengths.astype(np.int32)
    ln[3] = 3                                   # shorter than k: no index
    rc[5, ln[5] - 2] = 4                        # an N among the last k
    ri = TP.read_indices(rc, ln, k=k)
    np.testing.assert_array_equal(ri, JP.read_indices(rc, ln, k=k))
    assert ri[3] == -1 and ri[5] == -1 and (ri >= 0).sum() > 20


# ---------------------------------------------------------- seeded searches

PK = {"mixed": 8, "dense": 6}


def reads_rows(idx, ri: np.ndarray, k: int) -> dict:
    """The seed lists of the entries in `ri` (the gold engine's
    exact_match): a table exact on every entry the reads of a test look up.
    A whole table is test_build_precalc_device_equals_jax_and_gold's
    business; on these worlds a short k-mer's list runs past a hundred
    intervals on the way, which makes whole builds slow on the CPU."""
    rows = {}
    for e in sorted(set(int(x) for x in ri if x >= 0)):
        digits = np.array([(e >> (2 * (k - 1 - t))) & 3 for t in range(k)],
                          dtype=np.int8)
        rows[e] = exact_match(idx, digits, k, AlnParams())
    return rows


def rows_table(rows: dict, k: int):
    """A PrecalcTable holding `rows` and nothing else."""
    cnt = np.zeros(4 ** k, dtype=np.int32)
    for e, iv in rows.items():
        cnt[e] = len(iv)
    off = np.zeros(4 ** k + 1, dtype=np.int64)
    np.cumsum(cnt, out=off[1:])
    flat = [v for e in sorted(rows) for v in rows[e]]
    return TP.PrecalcTable(
        cnt=cnt, off=off, L=np.array([v[0] for v in flat], dtype=np.int64),
        U=np.array([v[1] for v in flat], dtype=np.int64))


@pytest.fixture(scope="module")
def seeded(small_worlds):
    """Per world: the reads' seed table at the world's precalc_len and the
    reads' D bounds from the JAX device pass."""
    out = {}
    for name, w in small_worlds.items():
        k = PK[name]
        reads = w["reads"]
        seq = np.asarray(reads.seq, dtype=np.int8)
        rc = np.asarray(reads.rc, dtype=np.int8)
        ln = reads.lengths.astype(np.int32)
        ri = TP.read_indices(rc, ln, k=k)
        D, Ds, _ = j_calc_d_chunk(w["jdx"], jnp.asarray(seq), jnp.asarray(ln),
                                  ln, JParams(max_diff=3), K=16)
        out[name] = dict(w, table=rows_table(reads_rows(w["idx"], ri, k), k),
                         rc=rc, ln=ln, D=D, Ds=Ds, k=k, ri=ri)
    return out


def _params(s, multiref, seed_slots):
    kw = dict(max_diff=3, batch_size=128, precalc_len=s["k"],
              use_precalc=True, is_multiref=multiref)
    return JParams(**kw), AlnParams(**kw)


def _seeds(s, seed_slots, sel=slice(None)):
    sL, sU, scnt, over = s["table"].lookup_batch(s["ri"][sel], seed_slots)
    return sL.astype(np.int32), sU.astype(np.int32), scnt, over


def _root_stats(scnt, over):
    return (f"roots/read mean {scnt.mean():.2f} max {scnt.max()}, "
            f">1 root {np.mean(scnt > 1):.2f}, seed_over {over.mean():.2f}")


def j_paths_seeded(ref, live, nroot, nc, pathcap):
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
                               jnp.asarray(na), nroot=nroot,
                               nslot=1 + 2 * nc, nc=nc, pathcap=pathcap))
        out[lanes, slots] = pr[:lanes.size]
    return out


def fixed_both(s, multiref, cap, kx, seed_slots, sel=slice(None),
               max_iters=20_000):
    jp, tp = _params(s, multiref, seed_slots)
    sL, sU, scnt, over = _seeds(s, seed_slots, sel)
    rc, ln = s["rc"][sel], s["ln"][sel]
    D, Ds = np.array(s["D"])[sel], np.array(s["Ds"])[sel]
    ref, rlive = as_numpy(j_fixed(
        s["jdx"], jnp.asarray(rc), jnp.asarray(ln), jnp.asarray(D),
        jnp.asarray(Ds), jp,
        JConfig(cap=cap, acap=24, kx=kx, max_iters=max_iters, backend="xla"),
        seed_L=jnp.asarray(sL), seed_U=jnp.asarray(sU),
        seed_cnt=jnp.asarray(scnt)))
    got, glive = as_numpy(inexact_search(
        s["tdx"], rc, ln, D, Ds, tp,
        EngineConfig(cap=cap, acap=24, kx=kx, max_iters=max_iters),
        seed_L=sL, seed_U=sU, seed_cnt=scnt, device="cpu"))
    return ref, rlive, got, glive, scnt, over


CASES = [("mixed", True, 16384, 4, 6), ("dense", True, 4096, 2, 6),
         ("mixed", False, 4096, 4, 4)]


@pytest.mark.parametrize("world,multiref,cap,kx,seed_slots", CASES)
def test_seeded_fixed_search_matches_jax(seeded, world, multiref, cap, kx,
                                         seed_slots):
    """The fixed-batch contract with seeded roots: fields and state paths equal
    on every read the JAX batch finished, the port's overflow set a subset
    of JAX's; `walk_paths` over the returned arena with nroot = seed_slots
    gives the in-kernel walk.  Reads over `seed_slots` are compared too."""
    s = seeded[world]
    ref, rlive, got, glive, scnt, over = fixed_both(s, multiref, cap, kx,
                                                    seed_slots)
    msg = _root_stats(scnt, over)
    assert 0 < over.mean() < 0.6 and (scnt > 1).mean() > 0.3, msg
    nc = 11 if multiref else 4
    pc = s["reads"].max_len + 32
    ok = ~ref["overflow"]
    assert ok.sum() > 0 and int(ref["n_alns"][ok].sum()) > 0, msg
    assert not got["overflow"][ok].any(), msg
    assert got["overflow"].sum() <= ref["overflow"].sum()
    for k in PER_READ:
        np.testing.assert_array_equal(ref[k][ok], got[k][ok], err_msg=k)
    g_paths = unpack_paths(got["paths"], pc)
    np.testing.assert_array_equal(
        j_paths_seeded(ref, rlive, seed_slots, nc, pc)[ok], g_paths[ok])
    # a seeded alignment's path length counts the seed
    assert (got["o_plen"][glive & ok[:, None]] >= s["k"]).all()
    glive = glive & ~got["overflow"][:, None]
    lanes, slots = np.nonzero(glive)
    walked = walk_paths(torch.from_numpy(got["arena"]),
                        torch.from_numpy(lanes),
                        torch.from_numpy(got["o_node"][lanes, slots]),
                        nroot=seed_slots, nslot=1 + 2 * nc, nc=nc,
                        pathcap=pc)
    np.testing.assert_array_equal(walked.numpy(), g_paths[lanes, slots])
    assert got["root_rd"].sum() > 0


@pytest.mark.parametrize("world,multiref,cap,kx,seed_slots", CASES)
def test_seeded_queued_search_matches_jax(seeded, world, multiref, cap, kx,
                                          seed_slots):
    """The ring launch with seeded roots and fewer lanes than reads: the
    per-read clock is exact, so the overflow sets are equal, and every
    field and path of the reads that finish is equal."""
    s = seeded[world]
    jp, tp = _params(s, multiref, seed_slots)
    sL, sU, scnt, over = _seeds(s, seed_slots)
    D, Ds = np.array(s["D"]), np.array(s["Ds"])
    ref = j_queued(s["jdx"], jnp.asarray(s["rc"]), jnp.asarray(s["ln"]),
                   s["D"], s["Ds"], jp,
                   JConfig(cap=cap, acap=24, kx=kx, max_iters=20_000,
                           flush=16, backend="xla"), lanes=128,
                   seed_L=jnp.asarray(sL), seed_U=jnp.asarray(sU),
                   seed_cnt=jnp.asarray(scnt))
    got = inexact_search_queued(
        s["tdx"], s["rc"], s["ln"], D, Ds, tp,
        EngineConfig(cap=cap, acap=24, kx=kx, max_iters=20_000),
        lanes=16, seed_L=sL, seed_U=sU, seed_cnt=scnt, device="cpu")
    ref, rlive = as_numpy(ref)
    got, glive = as_numpy(got)
    msg = _root_stats(scnt, over)
    np.testing.assert_array_equal(ref["overflow"], got["overflow"], msg)
    ok = ~got["overflow"]
    assert ok.sum() > 0 and int(got["n_alns"][ok].sum()) > 0, msg
    for k in PER_READ:
        np.testing.assert_array_equal(ref[k][ok], got[k][ok], err_msg=k)
    pc = s["reads"].max_len + 32
    live = rlive & ok[:, None]
    np.testing.assert_array_equal(
        j_unpack(np.asarray(ref["paths"]), pc)[live],
        unpack_paths(got["paths"], pc)[live])


def test_seeded_ring_overflow_matches_jax(seeded):
    """An arena of the reads' median pop count: the seeded ring budget,
    NFRAME = (cap - NROOT) // NSLOT - 1 pops a read with root pops counted,
    overflows about half of the reads, and the overflow sets agree."""
    s = seeded["mixed"]
    jp, tp = _params(s, True, 6)
    sL, sU, scnt, over = _seeds(s, 6)
    D, Ds = np.array(s["D"]), np.array(s["Ds"])

    def port(cap):
        return as_numpy(inexact_search_queued(
            s["tdx"], s["rc"], s["ln"], D, Ds, tp,
            EngineConfig(cap=cap, acap=24, kx=4, max_iters=20_000),
            lanes=16, seed_L=sL, seed_U=sU, seed_cnt=scnt,
            device="cpu"))[0]

    roomy = port(16384)
    assert not roomy["overflow"].any()
    nframe = int(np.median(roomy["pops"]))
    cap = 6 + 23 * (nframe + 1)
    ref = j_queued(s["jdx"], jnp.asarray(s["rc"]), jnp.asarray(s["ln"]),
                   s["D"], s["Ds"], jp,
                   JConfig(cap=cap, acap=24, kx=4, max_iters=20_000,
                           flush=16, backend="xla"), lanes=128,
                   seed_L=jnp.asarray(sL), seed_U=jnp.asarray(sU),
                   seed_cnt=jnp.asarray(scnt))
    ref, _ = as_numpy(ref)
    got = port(cap)
    assert 0 < got["overflow"].sum() < got["overflow"].size
    np.testing.assert_array_equal(ref["overflow"], got["overflow"])
    # the budget binds at NFRAME own pops, root pops included
    assert not got["overflow"][roomy["pops"] < nframe].any()
    assert got["overflow"][roomy["pops"] > nframe].all()
    ok = ~got["overflow"]
    for k in PER_READ:
        np.testing.assert_array_equal(ref[k][ok], got[k][ok], err_msg=k)


def test_seeded_fixed_budget_equals_jax_with_one_read_in_the_batch(seeded):
    """One read with several roots in a batch of its own, at arenas one
    frame below and exactly at its own pop count, with NROOT = 6 taken off
    the rows before the frames: the JAX wave clock is the read's own, so the
    flags are equal, and NFRAME's dependence on NROOT is pinned."""
    s = seeded["mixed"]
    NROOT = 6
    _, _, roomy, _, scnt, _ = fixed_both(s, True, 16384, 4, NROOT)
    done = np.flatnonzero(~roomy["overflow"] & (roomy["n_alns"] > 0)
                          & (scnt > 1) & (roomy["pops"] > 4))
    picked = done[np.argsort(roomy["pops"][done], kind="stable")][:3]
    assert picked.size == 3
    for r in picked:
        pops = int(roomy["pops"][r])
        for nframe in (pops - 1, pops):
            cap = NROOT + 23 * (nframe + 1)
            ref, _, got, _, _, _ = fixed_both(s, True, cap, 4, NROOT,
                                              sel=slice(r, r + 1),
                                              max_iters=100_000)
            over = bool(got["overflow"][0])
            assert bool(ref["overflow"][0]) == over, (nframe, r)
            assert over == (pops > nframe), (nframe, r)
            if not over:
                for k in PER_READ:
                    np.testing.assert_array_equal(ref[k], got[k], err_msg=k)


# ---------------------------------------------------------------- pipeline

P_LEN = 6


@pytest.fixture(scope="module")
def pipe_pre(pipe_world):
    """The fixed-path world of test_torch_fixed with a precalc_len-6 table
    (several roots a read from its IUPAC codes), the gold engine's `.aln`
    and the JAX pipeline's, both with the same table."""
    w = pipe_world
    params = AlnParams(max_diff=2, batch_size=128, precalc_len=P_LEN,
                       use_precalc=True)
    table = TP.build_precalc_device(
        w["idx"], TDI.from_fmindex(w["idx"], device="cpu"), params, k=P_LEN,
        K=16, max_level_full=4, sub_batch=4096, device="cpu")
    gold = b"".join(encode_alns(a) for a in align_reads_gold(
        w["idx"], w["reads"], params, precalc=table))
    jidx = JFMIndex.load(w["fa"] + ".bwt")
    jtable = JP.PrecalcTable(cnt=table.cnt, off=table.off, L=table.L,
                             U=table.U)
    jalns = j_align_device(
        jidx, JDI.from_fmindex(jidx), j_read_fastq(w["fq"]),
        JParams(max_diff=2, batch_size=128, precalc_len=P_LEN,
                use_precalc=True),
        JConfig(cap=4096, acap=24), d_cap=32, precalc=jtable, seed_slots=2,
        deep_tiers=False, gold_overlap=False)
    return dict(w, params=params, table=table, gold=gold,
                jax=b"".join(j_encode(a) for a in jalns))


@pytest.mark.parametrize("queued", [False, True])
@pytest.mark.parametrize("native", [False, True])
def test_seeded_pipeline_bytes_equal_jax_and_gold(pipe_pre, queued, native,
                                                  request, monkeypatch):
    """align_reads_device(precalc=...) over two batches, fixed or queued,
    with or without the native library (and so with or without the gold
    pool and the deep tier): `.aln` bytes equal the JAX pipeline's and the
    gold engine's with the same table, whichever branch a read took; reads
    over `seed_slots` (2) resolve on the gold engine."""
    w = pipe_pre
    if native:
        lib = request.getfixturevalue("native_lib")
        monkeypatch.setattr(t_native, "_native", lib)
    else:
        monkeypatch.setattr(t_native, "_native", None)
    monkeypatch.setattr(t_native, "_tried", True)
    stats: dict = {}
    alns = align_reads_device(
        w["idx"], TDI.from_fmindex(w["idx"], device="cpu"), w["reads"],
        w["params"], EngineConfig(cap=4096, acap=24), d_cap=32, stats=stats,
        precalc=w["table"], seed_slots=2, queued=queued, qchunk=1,
        device="cpu")
    got = b"".join(encode_alns(a) for a in alns)
    assert got == w["gold"]
    assert got == w["jax"]
    assert stats["launches"] >= 2 and stats["root_rows"] > 0
    assert 0 < stats["seed_over_reads"] <= stats["fallback_reads"], stats
    assert stats["no_seed_hit_reads"] >= 0


def test_lookup_seeds_counts_each_launched_read_once(pipe_pre):
    """A launch's seed lookup equals lookup_batch over the table, and the
    pipeline's `no_seed_hit_reads`/`seed_over_reads` count a read once
    however often it is launched (a deep tier launches a read again)."""
    w = pipe_pre
    rd, p, table = w["reads"], w["params"], w["table"]
    rc = np.asarray(rd.rc, dtype=np.int8)
    ln = rd.lengths.astype(np.int32)
    ri = TP.read_indices(rc, ln, k=int(p.precalc_len))
    cnt = np.where(ri < 0, 0, table.cnt[np.clip(ri, 0, len(table) - 1)])
    seen = np.zeros(rd.count, dtype=bool)
    counters = dict(no_seed_hit_reads=0, seed_over_reads=0)
    ids = np.arange(rd.count)
    half = rd.count // 2
    for sel in (ids[:half + 3], ids[half:], ids):
        seeds, over = _lookup_seeds(table, rc[sel], ln[sel], p, 2, "cpu",
                                    sel, seen, counters)
        np.testing.assert_array_equal(over, cnt[sel] > 2)
        np.testing.assert_array_equal(seeds[2].numpy(),
                                      np.minimum(cnt[sel], 2))
    assert counters == dict(no_seed_hit_reads=int((cnt == 0).sum()),
                            seed_over_reads=int((cnt > 2).sum()))
    assert counters["seed_over_reads"] > 0, counters


def _sparse_pre(path, entries: dict, k: int = 12) -> None:
    """A `.pre` file of 4^k records in which only `entries` (index ->
    interval list) are not empty, written piecewise."""
    with open(path, "wb") as f:
        prev = 0
        for e in sorted(entries):
            f.write(np.zeros(e - prev, dtype="<i4").tobytes())
            iv = entries[e]
            f.write(np.array([len(iv)], dtype="<i4").tobytes())
            f.write(np.array(iv, dtype="<u8").reshape(-1).tobytes())
            prev = e + 1
        f.write(np.zeros(4 ** k - prev, dtype="<i4").tobytes())


def test_cli_align_P_equals_gold_with_a_prepared_table(pipe_world, native_lib,
                                                       monkeypatch, tmp_path):
    """CLI `align -P --device cpu` (fixed batches, then `--queued`) and
    `align -P --engine gold` on the CPU, handed a prepared `<fasta>.pre` at
    the CLI's k = 12 that is exact on every entry the reads look up: the
    same `.aln` bytes as the gold engine with that table."""
    monkeypatch.setattr(t_native, "_native", native_lib)
    monkeypatch.setattr(t_native, "_tried", True)
    w = pipe_world
    fa = str(tmp_path / "c.fa")
    for ext in ("", ".bwt", ".ann", ".ref"):
        with open(w["fa"] + ext, "rb") as f, open(fa + ext, "wb") as g:
            g.write(f.read())
    reads = w["reads"]
    ri = TP.read_indices(np.asarray(reads.rc, dtype=np.int8),
                         reads.lengths.astype(np.int32), k=12)
    entries = reads_rows(w["idx"], ri, 12)
    _sparse_pre(fa + ".pre", entries)
    table = TP.load_pre(fa + ".pre")
    assert sum(int(table.cnt[e] > 0) for e in entries) > 100
    gold = b"".join(encode_alns(a) for a in align_reads_gold(
        w["idx"], reads, AlnParams(max_diff=2, use_precalc=True),
        precalc=table))
    for extra in (["--device", "cpu", "--batch", "128"],
                  ["--device", "cpu", "--batch", "128", "--queued"],
                  ["--engine", "gold"]):
        out = str(tmp_path / "o.aln")
        assert cli.main(["align", "-n", "2", "-P", *extra, fa, w["fq"],
                         out]) == 0
        with open(out, "rb") as f:
            assert f.read() == gold, extra
    assert sum(1 for a in read_aln_file(out) if a) > 100


def test_align_P_raises_without_cuda(pipe_world, tmp_path):
    """Without `--device cpu` and with no CUDA device, `align -P` raises
    before it builds a table: no seeded path carries on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a CUDA device")
    w = pipe_world
    fa = str(tmp_path / "c.fa")
    for ext in ("", ".bwt"):
        with open(w["fa"] + ext, "rb") as f, open(fa + ext, "wb") as g:
            g.write(f.read())
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["align", "-n", "2", "-P", fa, w["fq"],
                  str(tmp_path / "o.aln")])
    assert not os.path.exists(fa + ".pre")
    with pytest.raises(RuntimeError, match="CUDA"):
        TP.build_precalc_device(w["idx"],
                                TDI.from_fmindex(w["idx"], device="cpu"),
                                AlnParams(), k=2)
