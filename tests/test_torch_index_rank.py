"""Device index layout and rank ops of the port against the JAX package:
same numpy inputs through both, all integers, tolerance zero."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bwbble_tpu.engine import device_index as JDI
from bwbble_tpu.engine import rank as JR

from bwbble_tpu_torch import constants as C
from bwbble_tpu_torch import worlds
from bwbble_tpu_torch.align.params import AlnParams
from bwbble_tpu_torch.engine import device_index as TDI
from bwbble_tpu_torch.engine import inexact as TI
from bwbble_tpu_torch.engine import rank as TR
from bwbble_tpu_torch.formats.fasta import fasta2ref
from bwbble_tpu_torch.index import FMIndex
from bwbble_tpu_torch.testutil import random_genome_fasta

torch.set_num_threads(1)


@pytest.fixture(scope="module",
                params=["small", "iupac_dense", "single_genome"])
def pair(request, tmp_path_factory):
    d = str(tmp_path_factory.mktemp(request.param))
    if request.param == "small":
        fa = d + "/w.fa"
        random_genome_fasta(fa, {"21": 20_000, "22": 3_000}, seed=1,
                            iupac_frac=0.002)
        codes, _ = fasta2ref(fa, fa + ".ref", fa + ".ann")
        idx = FMIndex.build(codes)
    elif request.param == "iupac_dense":
        idx, _ = worlds.iupac_dense_world(d)
    else:
        idx, _ = worlds.single_genome_world()
    return idx, JDI.from_fmindex(idx), TDI.from_fmindex(idx, device="cpu")


def test_from_fmindex_bytes_equal(pair):
    idx, jdx, tdx = pair
    for name in ("table", "Carr", "sa_samples"):
        a = np.asarray(getattr(jdx, name))
        b = getattr(tdx, name).numpy()
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name
    assert (int(jdx.length), int(jdx.sa0)) == (tdx.length, tdx.sa0)
    # the same index handed over as arrays
    tdx2 = TDI.from_arrays(np.asarray(jdx.table), np.asarray(jdx.Carr),
                           np.asarray(jdx.sa_samples), int(jdx.length),
                           int(jdx.sa0), device="cpu")
    assert torch.equal(tdx2.table, tdx.table)


def _positions(idx, rng, n=600):
    edge = [-1, 0, 1, 127, 128, idx.length - 2, idx.length - 1]
    return np.concatenate([rng.integers(-1, idx.length, n),
                           edge]).astype(np.int32)


@pytest.mark.parametrize("fn", ["rank_all_exact", "rank_all_dfs"])
def test_rank_all_equal(pair, fn):
    idx, jdx, tdx = pair
    i = _positions(idx, np.random.default_rng(3))
    for inc in (0, 1):
        a = np.asarray(getattr(JR, fn)(jdx, jnp.asarray(i), inc))
        b = getattr(TR, fn)(tdx, torch.from_numpy(i), inc).numpy()
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("fn", ["rank_all_exact_pair", "rank_all_dfs_pair"])
def test_rank_pairs_equal(pair, fn):
    idx, jdx, tdx = pair
    rng = np.random.default_rng(4)
    iL, iU = _positions(idx, rng), _positions(idx, rng)
    a = getattr(JR, fn)(jdx, jnp.asarray(iL), jnp.asarray(iU))
    b = getattr(TR, fn)(tdx, torch.from_numpy(iL), torch.from_numpy(iU))
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), y.numpy())


def test_rank1_bwt_char_inv_psi_equal(pair):
    idx, jdx, tdx = pair
    rng = np.random.default_rng(5)
    i = _positions(idx, rng)
    c = rng.integers(0, 16, i.size).astype(np.int32)
    np.testing.assert_array_equal(
        np.asarray(JR.rank1(jdx, jnp.asarray(c), jnp.asarray(i))),
        TR.rank1(tdx, torch.from_numpy(c), torch.from_numpy(i)).numpy())
    a, b = JR.rank1_pair(jdx, jnp.asarray(c), jnp.asarray(i),
                         jnp.asarray(i[::-1].copy()))
    x, y = TR.rank1_pair(tdx, torch.from_numpy(c), torch.from_numpy(i),
                         torch.from_numpy(i[::-1].copy()))
    np.testing.assert_array_equal(np.asarray(a), x.numpy())
    np.testing.assert_array_equal(np.asarray(b), y.numpy())
    ii = np.clip(i, 0, None)
    np.testing.assert_array_equal(
        np.asarray(JR.bwt_char(jdx, jnp.asarray(ii))),
        TR.bwt_char(tdx, torch.from_numpy(ii)).numpy())
    np.testing.assert_array_equal(
        np.asarray(JR.inv_psi(jdx, jnp.asarray(ii))),
        TR.inv_psi(tdx, torch.from_numpy(ii)).numpy())


def test_kernel_alphabet_formulas_match_constants():
    """csrc/ring_search.cu derives its alphabet tables from the Gray-code
    definition; the same formulas must reproduce constants.py."""
    gray = [j ^ (j >> 1) for j in range(16)]
    pop = [bin(g).count("1") for g in gray]
    assert gray == [int(x) for x in C.GRAY_VAL]
    assert tuple(j for j in range(16) if pop[j] == 3) == C.SKIPPED_ORDERS
    assert [int(p >= 2) for p in pop] == [int(x) for x in C.IS_SNP]
    assert gray.index(15) == C.ORDER_N
    base_mask = [8, 2, 4, 1]           # nt4 A, G, C, T
    assert base_mask == [int(x) for x in C.NT4_BASE_MASK[:4]]
    for c in range(4):
        assert [j for j in range(1, 16)
                if gray[j] & base_mask[c] and gray[j] != 15] == \
            [int(x) for x in C.NUCL_BASES[c]]
        assert [int(bool(gray[j] & base_mask[c])) for j in range(16)] == \
            [int(x) for x in C.MATCH_MATRIX[c]]
    assert TI.alphabet(True) == tuple(j for j in range(1, 16)
                                      if pop[j] != 3)
    # single genome: the pure bases in nt4 order, 9 slots in a 40-word row
    assert TI.alphabet(False) == tuple(gray.index(m) for m in base_mask)
    assert TI.alphabet(False) == tuple(int(x) for x in C.NT4_GRAY[:4])
    p4 = AlnParams(max_diff=2, is_multiref=False)
    s16 = TI.ring_statics(AlnParams(max_diff=2), TI.EngineConfig(), 100, 33)
    s4 = TI.ring_statics(p4, TI.EngineConfig(), 100, 33)
    assert (s16.NC, s16.NSLOT, s16.ROWW) == (11, 23, 128) and s16.NROOT == 1
    assert not s16.seeded and s16.PK == 0
    # a seeded launch: NROOT root rows a read come off the frame budget
    s32 = TI.ring_statics(AlnParams(max_diff=2), TI.EngineConfig(), 100, 33,
                          seed_slots=32)
    assert (s32.seeded, s32.NROOT, s32.PK) == (True, 32, 12)
    assert s32.NFRAME == (32768 - 32) // 23 - 1 == s16.NFRAME - 1
    assert (s4.NC, s4.NSLOT, s4.ROWW) == (4, 9, 40)
    assert s4.NSLOT * 4 + 1 <= s4.ROWW and s4.ROWW % 4 == 0
