"""Interval lists, D bounds and exact search of the port against the JAX
package: same numpy inputs through both, all integers, tolerance zero."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bwbble_tpu.engine import dbound as JD
from bwbble_tpu.engine import device_index as JDI
from bwbble_tpu.engine import exact as JE
from bwbble_tpu.engine import intervals as JI

from bwbble_tpu_torch import worlds
from bwbble_tpu_torch.engine import dbound as TD
from bwbble_tpu_torch.engine import device_index as TDI
from bwbble_tpu_torch.engine import exact as TE
from bwbble_tpu_torch.engine import intervals as TIV

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    idx, rd = worlds.iupac_dense_world(str(tmp_path_factory.mktemp("d")))
    seq = np.asarray(rd.seq, dtype=np.int8).copy()
    seq[3, 7] = 4                       # an N inside a read
    lengths = rd.lengths.astype(np.int32).copy()
    lengths[5] = 20                     # a shorter read
    return (idx, JDI.from_fmindex(idx), TDI.from_fmindex(idx, device="cpu"),
            seq, lengths)


def _eq(a, b):
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), y.numpy())


def test_merge_compact_equal():
    rng = np.random.default_rng(7)
    B, M, K = 64, 28, 4
    L = np.sort(rng.integers(0, 60, (B, M)), axis=1).astype(np.int32)
    U = (L + rng.integers(0, 3, (B, M))).astype(np.int32)
    L[:, 1:] = np.where(rng.random((B, M - 1)) < 0.4, U[:, :-1] + 1,
                        L[:, 1:])
    valid = rng.random((B, M)) < 0.5
    _eq(JI.merge_compact(jnp.asarray(L), jnp.asarray(U), jnp.asarray(valid),
                         K),
        TIV.merge_compact(torch.from_numpy(L), torch.from_numpy(U),
                          torch.from_numpy(valid), K))


@pytest.mark.parametrize("K", [2, 16])
def test_expand_step_equal(world, K):
    idx, jdx, tdx, seq, lengths = world
    rng = np.random.default_rng(8)
    B = seq.shape[0]
    Ls = np.zeros((B, K), dtype=np.int32)
    Us = np.full((B, K), -1, dtype=np.int32)
    Us[:, 0] = idx.length - 1
    cnt = np.ones(B, dtype=np.int32)
    for step in range(6):               # a few chained steps widen the lists
        c = rng.integers(0, 5 if step == 3 else 4, B).astype(np.int32)
        a = JI.expand_step(jdx, jnp.asarray(Ls), jnp.asarray(Us),
                           jnp.asarray(cnt), jnp.asarray(c))
        b = TIV.expand_step(tdx, torch.from_numpy(Ls), torch.from_numpy(Us),
                            torch.from_numpy(cnt), torch.from_numpy(c))
        _eq(a, b)
        Ls, Us, cnt = (np.array(a[0]), np.array(a[1]), np.array(a[2]))


@pytest.mark.parametrize("K", [2, 16])
def test_calc_d_equal(world, K):
    idx, jdx, tdx, seq, lengths = world
    a = JD.calc_d(jdx, jnp.asarray(seq), jnp.asarray(lengths), K=K)
    b = TD.calc_d(tdx, seq, lengths, K=K, device="cpu")
    _eq(a, b)
    sl = np.minimum(lengths, 12).astype(np.int32)
    _eq(JD.calc_d(jdx, jnp.asarray(seq), jnp.asarray(sl), K=K, max_len=12),
        TD.calc_d(tdx, seq, sl, K=K, max_len=12, device="cpu"))


def test_exact_search_equal(world):
    idx, jdx, tdx, seq, lengths = world
    _eq(JE.exact_search(jdx, jnp.asarray(seq), jnp.asarray(lengths), K=8),
        TE.exact_search(tdx, seq, lengths, K=8, device="cpu"))
