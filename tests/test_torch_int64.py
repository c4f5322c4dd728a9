"""The int64 whole-genome index layout in the port against the JAX package
(and the gold engine): the layout's table bytes, rank arithmetic above 2^31
on a virtual-offset index, the fixed search's per-read fields, the fixed
pipeline in multi-genome, `-S` and `-P` mode, and the refusal of queued
searches.  All comparisons are of integers and bytes: the tolerance is zero.

JAX's x64 mode must be set before JAX starts, so the JAX side runs once, in
a subprocess with JAX_ENABLE_X64=1 (as tests/test_int64.py runs it), and
hands its results over in a pickle; the port runs here, on the CPU.  The
worlds are the port's small test worlds (worlds.mixed_world: 4 kbp with an
IUPAC-dense tail, and its single-genome counterpart) built in the int64
layout although they are far below 2^31 positions.
"""

import dataclasses
import os
import pickle
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from bwbble_tpu_torch import worlds
from bwbble_tpu_torch.align import precalc as TP
from bwbble_tpu_torch.align.params import AlnParams
from bwbble_tpu_torch.align.pipeline import align_reads_gold
from bwbble_tpu_torch.engine import device_index as TDI
from bwbble_tpu_torch.engine import kernel
from bwbble_tpu_torch.engine.inexact import (EngineConfig, inexact_search,
                                             inexact_search_queued,
                                             ring_statics, unpack_paths,
                                             walk_paths)
from bwbble_tpu_torch.engine.pipeline import align_reads_device
from bwbble_tpu_torch.engine.rank import rank1, rank_all_exact
from bwbble_tpu_torch.formats.aln import encode_alns

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OFF = 3 << 32                 # the virtual-offset index's shift
NBLK = 64
FIELDS = ("n_alns", "o_L", "o_U", "o_score", "o_len", "o_mm", "o_go", "o_ge",
          "o_snp", "o_plen")
CAP, ACAP, KX = 8192, 32, 8
# the pipelines: an arena and D-list width at which the device search
# resolves most reads of the mixed world (its IUPAC-dense tail needs wide
# D lists), and seeds of 6 bases (a 4-mer has more intervals than slots)
PIPE_CAP, D_CAP, PK = 32768, 128, 6

_SCRIPT = r"""
import pickle, sys
import numpy as np
import jax
jax.config.update("jax_enable_x64", True)
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp

from bwbble_tpu.align import precalc as JP
from bwbble_tpu.align.params import AlnParams
from bwbble_tpu.engine import device_index as DI
from bwbble_tpu.engine import rank as R
from bwbble_tpu.engine.inexact import EngineConfig, inexact_search
from bwbble_tpu.engine.inexact import inexact_search_queued, walk_paths
from bwbble_tpu.engine.pipeline import _calc_d_chunk, align_reads_device
from bwbble_tpu.formats.aln import encode_alns
from bwbble_tpu_torch import worlds

OFF, NBLK, CAP, ACAP, KX, PIPE_CAP, D_CAP, PK = %(consts)s
out = {}

# 1. the layout of the mixed world
idx, reads = worlds.mixed_world()
d64 = DI.from_fmindex(idx, use_int64=True)
assert d64.idt == jnp.int64
out["layout"] = {k: np.asarray(getattr(d64, k))
                 for k in ("table", "Carr", "sa_samples")}

# 2. a virtual-offset index (tests/test_int64.py): real in-block codes,
# every cumulative count and C shifted by OFF
rng = np.random.default_rng(3)
blocks = rng.integers(0, 16, size=(NBLK, 128)).astype(np.int8)
occ = rng.integers(0, 100, size=(NBLK, 16)).astype(np.int64) + OFF
table = np.concatenate(
    [DI.build_planes(blocks),
     (occ & 0xFFFFFFFF).astype(np.uint32).view(np.int32),
     (occ >> 32).astype(np.int32)], axis=1)
Carr = np.arange(17, dtype=np.int64) * 7 + OFF
length = np.int64(NBLK) * 128 + OFF
vd = DI.DeviceIndex(table=jnp.asarray(table), Carr=jnp.asarray(Carr),
                    sa_samples=jnp.asarray(np.zeros(4, dtype=np.int64)),
                    length=jnp.asarray(length), sa0=jnp.asarray(np.int64(1)))
pos = rng.integers(0, NBLK * 128 - 2, size=256).astype(np.int64)
cs = rng.integers(0, 16, size=256).astype(np.int32)
out["virtual"] = dict(
    blocks=blocks, occ=occ, table=table, Carr=Carr, length=int(length),
    pos=pos, cs=cs,
    rank_all=np.asarray(R.rank_all_exact(vd, jnp.asarray(pos), 0)),
    rank1=np.asarray(R.rank1(vd, jnp.asarray(cs), jnp.asarray(pos))))

# 3. the fixed search (the XLA body) on the mixed world's reads
p = AlnParams(max_diff=3, batch_size=128)
seq = np.asarray(reads.seq, dtype=np.int8)
rc = np.asarray(reads.rc, dtype=np.int8)
ln = reads.lengths.astype(np.int32)
D, Ds, _ = _calc_d_chunk(d64, jnp.asarray(seq), jnp.asarray(ln), ln, p, K=16)
cfg = EngineConfig(cap=CAP, acap=24, kx=2, max_iters=20_000, backend="xla")
res = inexact_search(d64, jnp.asarray(rc), jnp.asarray(ln), D, Ds, p, cfg)
r = {k: np.asarray(v) for k, v in res.items()}
live = np.arange(r["o_L"].shape[1])[None, :] < r["n_alns"][:, None]
lanes, slots = np.nonzero(live & ~r["overflow"][:, None])
W = max(256, 1 << int(max(lanes.size, 1) - 1).bit_length())
la = np.zeros(W, dtype=np.int32)
na = np.full(W, -1, dtype=np.int32)
la[:lanes.size] = lanes
na[:lanes.size] = r["o_node"][lanes, slots]
pathcap = reads.max_len + 32
paths = np.asarray(walk_paths(r["arena"], jnp.asarray(la), jnp.asarray(na),
                              nroot=1, nslot=23, nc=11, pathcap=pathcap,
                              nw=6))[:lanes.size]
del r["arena"]
out["search"] = dict(D=np.asarray(D), Ds=np.asarray(Ds), res=r,
                     lanes=lanes, slots=slots, paths=paths)

# 4. the fixed pipeline: multi-genome, -S, -P (a gold-built table)
cfg = EngineConfig(cap=PIPE_CAP, acap=ACAP, kx=KX)
out["pipeline"] = {}
sidx, sreads = worlds.single_genome_world()
pre = JP.build_precalc_gold(idx, AlnParams(), k=PK)
runs = {
    "multi": (idx, reads, AlnParams(max_diff=3, batch_size=64), None),
    "single": (sidx, sreads,
               AlnParams(max_diff=3, batch_size=64, is_multiref=False), None),
    "seeded": (idx, reads, AlnParams(max_diff=3, batch_size=64,
                                     precalc_len=PK, use_precalc=True), pre),
}
for name, (ix, rd, pp, pc) in runs.items():
    alns = align_reads_device(ix, DI.from_fmindex(ix, use_int64=True), rd,
                              pp, cfg, d_cap=D_CAP, sort_reads=False,
                              precalc=pc)
    out["pipeline"][name] = b"".join(encode_alns(a) for a in alns)

# 5. a queued search on the int64 layout is refused
try:
    inexact_search_queued(d64, jnp.zeros((8, 32), jnp.int32),
                          jnp.full((8,), 32, jnp.int32),
                          jnp.zeros((8, 33, 2), jnp.int64),
                          jnp.zeros((8, 33, 2), jnp.int64), p, cfg, lanes=8)
    out["queued"] = None
except NotImplementedError as e:
    out["queued"] = str(e)

with open(sys.argv[1], "wb") as f:
    pickle.dump(out, f)
"""


@pytest.fixture(scope="module")
def jax64(tmp_path_factory):
    """The JAX package's results under x64, from one subprocess."""
    path = tmp_path_factory.mktemp("jax64") / "ref.pkl"
    script = _SCRIPT % {"consts": repr((OFF, NBLK, CAP, ACAP, KX, PIPE_CAP,
                                        D_CAP, PK))}
    env = dict(os.environ, JAX_ENABLE_X64="1", JAX_PLATFORMS="cpu",
               PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", script, str(path)], env=env,
                       cwd=REPO, capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stdout + r.stderr
    with open(path, "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def mixed():
    return worlds.mixed_world()


def test_int64_layout_equals_jax(jax64, mixed):
    """48-word rows (planes, low count words as uint32 bits, high words),
    Carr and the SA samples in int64: the JAX package's bytes."""
    idx, _ = mixed
    d = TDI.from_fmindex(idx, use_int64=True, device="cpu")
    assert d.idt == torch.int64 and d.table.shape[1] == 48
    ref = jax64["layout"]
    for k in ("table", "Carr", "sa_samples"):
        got = getattr(d, k).numpy()
        assert got.dtype == ref[k].dtype, k
        np.testing.assert_array_equal(got, ref[k], err_msg=k)
    # the automatic choice is int32 below 2^31 positions, and 2^31 or more
    # positions are refused in the int32 layout
    assert TDI.from_fmindex(idx, device="cpu").idt == torch.int32
    with pytest.raises(ValueError, match="use_int64"):
        TDI.from_fmindex(types.SimpleNamespace(length=2**31),
                         use_int64=False, device="cpu")


def test_virtual_offset_rank_equals_jax_and_numpy(jax64):
    """rank_all_exact and rank1 on an index whose counts and C lie past
    2^33: equal to the JAX package and to a numpy int64 model."""
    v = jax64["virtual"]
    d = TDI.from_arrays(v["table"], v["Carr"], np.zeros(4, np.int64),
                        v["length"], 1, device="cpu")
    assert d.idt == torch.int64
    pos = torch.from_numpy(v["pos"])
    got = rank_all_exact(d, pos, 0).numpy()
    np.testing.assert_array_equal(got, v["rank_all"])
    got1 = rank1(d, torch.from_numpy(v["cs"]), pos).numpy()
    np.testing.assert_array_equal(got1, v["rank1"])
    blocks, occ, Carr = v["blocks"], v["occ"], v["Carr"]
    for t, p in enumerate(v["pos"].tolist()):
        k, o = p // 128, p % 128
        for j in range(1, 16):
            exp = (int(Carr[j]) + int(occ[k, j])
                   + int(np.sum(blocks[k, :o + 1] == j))
                   - (1 if blocks[k, 0] == j else 0))
            assert got[t, j] == exp, (t, j)
        c = int(v["cs"][t])
        exp1 = (int(occ[k, c]) + int(np.sum(blocks[k, :o + 1] == c))
                - (1 if blocks[k, 0] == c else 0)
                - (1 if c == 0 and k * 128 < 1 <= p else 0))
        assert got1[t] == exp1, t
    assert got[:, 1:].min() > 2**33


def test_fixed_search_fields_equal_jax_body(jax64, mixed):
    """Per-read fields of the plain fixed search on the int64 layout equal
    the JAX XLA body's on the reads it finished (slots below n_alns, C3),
    as do the reported paths and walk_paths over the six-word frame rows."""
    idx, reads = mixed
    s = jax64["search"]
    ref = s["res"]
    d = TDI.from_fmindex(idx, use_int64=True, device="cpu")
    got = inexact_search(d, np.asarray(reads.rc, dtype=np.int8),
                         reads.lengths.astype(np.int32), s["D"], s["Ds"],
                         AlnParams(max_diff=3, batch_size=128),
                         EngineConfig(cap=CAP, acap=24, kx=2,
                                      max_iters=20_000), device="cpu")
    got = {k: v.numpy() for k, v in got.items()}
    assert got["o_L"].dtype == np.int64 and got["arena"].shape[2] == 140
    ok = ~ref["overflow"]
    assert ok.sum() > 0 and int(ref["n_alns"][ok].sum()) > 0
    assert not got["overflow"][ok].any()
    live = np.arange(24)[None, :] < ref["n_alns"][:, None]
    for k in FIELDS:
        a = np.where(live, ref[k], 0) if ref[k].ndim == 2 else ref[k]
        b = np.where(live, got[k], 0) if got[k].ndim == 2 else got[k]
        np.testing.assert_array_equal(a[ok], b[ok], err_msg=k)
    lanes, slots = s["lanes"], s["slots"]
    pathcap = reads.max_len + 32
    g_paths = unpack_paths(got["paths"], pathcap)
    np.testing.assert_array_equal(g_paths[lanes, slots], s["paths"])
    walked = walk_paths(torch.from_numpy(got["arena"]),
                        torch.from_numpy(lanes),
                        torch.from_numpy(got["o_node"][lanes, slots]),
                        nroot=1, nslot=23, nc=11, pathcap=pathcap, nw=6)
    np.testing.assert_array_equal(walked.numpy(), s["paths"])


def _pipeline_run(name, idx, reads, int64: bool):
    """The port's `.aln` bytes of one pipeline run, and the run's stats."""
    p = {"multi": AlnParams(max_diff=3, batch_size=64),
         "single": AlnParams(max_diff=3, batch_size=64, is_multiref=False),
         "seeded": AlnParams(max_diff=3, batch_size=64, precalc_len=PK,
                             use_precalc=True)}[name]
    pre = TP.build_precalc_gold(idx, AlnParams(), k=PK) \
        if name == "seeded" else None
    d = TDI.from_fmindex(idx, use_int64=int64, device="cpu")
    st: dict = {}
    alns = align_reads_device(idx, d, reads, p,
                              EngineConfig(cap=PIPE_CAP, acap=ACAP, kx=KX),
                              d_cap=D_CAP, sort_reads=False, precalc=pre,
                              stats=st, device="cpu")
    return b"".join(encode_alns(a) for a in alns), p, st


@pytest.mark.parametrize("name", ["multi", "single", "seeded"])
def test_pipeline_int64_equals_jax_and_gold(jax64, name):
    """align_reads_device on the int64 layout: the `.aln` bytes of the JAX
    package's run on its int64 layout; unseeded, also those of the gold
    engine and of the port's own int32 run.  (The gold engine of `-P` is
    the slow Python one; the JAX run stands for it there.)"""
    idx, reads = (worlds.single_genome_world() if name == "single"
                  else worlds.mixed_world())
    got, p, st = _pipeline_run(name, idx, reads, True)
    # the device search resolved most reads
    assert st["launches"] > 0 and st["fallback_reads"] < reads.count // 2
    assert len(got) > 4 * reads.count
    assert got == jax64["pipeline"][name]
    if name != "seeded":
        gold = align_reads_gold(idx, reads, p)
        assert got == b"".join(encode_alns(a) for a in gold)
        assert got == _pipeline_run(name, idx, reads, False)[0]


def test_queued_search_refuses_int64_in_both_packages(jax64, mixed):
    idx, reads = mixed
    assert jax64["queued"] and "int64" in jax64["queued"]
    d = TDI.from_fmindex(idx, use_int64=True, device="cpu")
    p = AlnParams(max_diff=3, batch_size=8)
    with pytest.raises(NotImplementedError, match=jax64["queued"][:20]):
        inexact_search_queued(
            d, np.zeros((8, 32), np.int8), np.full(8, 32, np.int32),
            np.zeros((8, 33, 2), np.int64), np.zeros((8, 33, 2), np.int64),
            p, EngineConfig(cap=CAP), lanes=8, device="cpu")
    with pytest.raises(NotImplementedError, match="int64"):
        align_reads_device(idx, d, reads, p, EngineConfig(cap=CAP),
                           queued=True, device="cpu")
    with pytest.raises(NotImplementedError, match="int64"):
        ring_statics(p, EngineConfig(cap=CAP), 32, 33, fixed=False, x64=True)


def test_kernel_parameter_block_carries_the_length_past_2_to_31():
    """The kernel's int32 parameter block splits the length into its low
    32 bits (wrapped to int32) and its high 32 bits; the int64 frame rows
    are 140 and 56 words."""
    p = AlnParams(max_diff=3)
    S = ring_statics(p, EngineConfig(cap=CAP), 32, 33, fixed=True, x64=True)
    assert (S.NW, S.ROWW) == (6, 140)
    assert ring_statics(dataclasses.replace(p, is_multiref=False),
                        EngineConfig(cap=CAP), 32, 33, fixed=True,
                        x64=True).ROWW == 56
    for length in (6_200_000_000, OFF + 5, 2**31, 1000):
        hp = kernel.param_block(p, S, 4, 32, length, 4)
        lo, hi = int(hp[20]), int(hp[25])
        assert ((hi << 32) | (lo & 0xFFFFFFFF)) == length
        assert hp.dtype == np.int32 and hp.size == 26
