"""Suffix-array construction.

Primary path: native C++ SA-IS (induced sorting; Nong/Zhang/Chan 2009) via
ctypes — see native/sais.cpp.  Fallback: a vectorized numpy prefix-doubling
(Manber-Myers) implementation, O(n log^2 n), used when the native library is
unavailable (e.g. before the first build) and in tests.

The reference uses sais-lite in-RAM (mg-aligner/is.c) plus a streamed
40-bit external-SA ingest path (bwt.c:132-158); both capabilities are kept:
`suffix_array()` here, and `read_esa_40bit` for the external format.
"""

from __future__ import annotations

import numpy as np

from bwbble_tpu_torch.native import get_native


def suffix_array(seq: np.ndarray) -> np.ndarray:
    """Suffix array of `seq` (uint8 codes). Returns int64 [n] (no sentinel row).

    Suffixes are compared with the implicit convention that a shorter suffix
    (i.e. running off the end) sorts first, matching sais semantics.
    """
    nat = get_native()
    if nat is not None:
        return nat.suffix_array(seq)
    return _suffix_array_doubling(seq)


def _suffix_array_doubling(seq: np.ndarray) -> np.ndarray:
    n = int(seq.shape[0])
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    rank = seq.astype(np.int64)
    k = 1
    idx = np.arange(n, dtype=np.int64)
    while True:
        # key: (rank[i], rank[i+k]) with out-of-range treated as -1 (end-first)
        second = np.full(n, -1, dtype=np.int64)
        second[: n - k] = rank[k:]
        order = np.lexsort((second, rank))
        # recompute dense ranks
        r_o = rank[order]
        s_o = second[order]
        new_head = np.ones(n, dtype=bool)
        new_head[1:] = (r_o[1:] != r_o[:-1]) | (s_o[1:] != s_o[:-1])
        new_rank = np.cumsum(new_head) - 1
        rank = np.empty(n, dtype=np.int64)
        rank[order] = new_rank
        if new_rank[-1] == n - 1:
            return order
        k <<= 1
        if k >= n:
            # all ranks distinct by now except pathological equality; finish
            return idx[np.lexsort((idx, rank))]


def read_esa_40bit(path: str, n: int) -> np.ndarray:
    """Stream a 40-bit/entry external suffix array (esa2bwt, bwt.c:132-158).

    The file holds n little-endian 5-byte SA values for suffixes 1..n of the
    (n+1)-row conceptual SA whose row 0 is the virtual total-'$' (value n).
    Returns the full int64 [n+1] SA including that first row.
    """
    raw = np.fromfile(path, dtype=np.uint8)
    if raw.shape[0] < 5 * n:
        raise ValueError(f"external SA file too short: {raw.shape[0]} < {5*n}")
    raw = raw[: 5 * n].reshape(n, 5).astype(np.int64)
    vals = (raw[:, 0] | (raw[:, 1] << 8) | (raw[:, 2] << 16)
            | (raw[:, 3] << 24) | (raw[:, 4] << 32))
    return np.concatenate([np.array([n], dtype=np.int64), vals])
