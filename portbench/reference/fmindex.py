"""FM-index over the 16-letter multi-genome alphabet: the `.bwt` reader and
the query model of the plain reference.

Frozen copy of the loader and the numpy query operations (C, O,
O_alphabet, O_actg_alphabet) of bwbble_tpu_torch/index/fmindex.py, which
replicate the reference's exact semantics (bwt.c:311-781), including quirk
Q1 (the bulk 16-char scan never counts the 3-base codes B/H/V/D,
bwt.c:698-734) and the checkpoint first-char decrement (bwt.c:653,780).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from portbench.reference import constants as C

_HDR_DTYPE = np.dtype("<u8")
_SKIP = C.SKIPPED_ORDERS


@dataclasses.dataclass
class FMIndex:
    length: int          # BWT length = reference length + 1 (virtual '$' row)
    sa0: int             # row whose BWT char is the virtual '$'
    bwt: np.ndarray      # uint8 [length] Gray-order codes (code 0 at sa0)
    Carr: np.ndarray     # int64 [17] prefix counts, excludes the sa0 row
    occ: np.ndarray      # int64 [num_occ, 16] checkpoints every OCC_INTERVAL

    @classmethod
    def load(cls, path: str) -> "FMIndex":
        """Deserialize (load_bwt, bwt.c:90-125); the SA samples are not
        read."""
        import os
        size = os.path.getsize(path)
        if size < (5 + 17) * 8:
            raise ValueError(f"{path}: not a .bwt file ({size} bytes)")
        with open(path, "rb") as f:
            hdr = np.frombuffer(f.read(5 * 8), dtype=_HDR_DTYPE)
            length, num_words, _num_sa, num_occ, sa0 = (int(x) for x in hdr)
            Carr = np.frombuffer(f.read(17 * 8), dtype=_HDR_DTYPE
                                 ).astype(np.int64)
            words = np.frombuffer(f.read(num_words * 4), dtype="<u4")
            occ = np.frombuffer(f.read(num_occ * 16 * 8), dtype=_HDR_DTYPE
                                ).view(np.int64).reshape(num_occ, 16)
        return cls(length=length, sa0=sa0, bwt=unpack_words(words, length),
                   Carr=Carr, occ=occ)

    # ------------------------------------------------------------ query model

    def C_(self, c: int) -> int:
        return int(self.Carr[c])

    def O(self, c: int, i: int) -> int:
        """Rank of char c at position i (O, bwt.c:348-372)."""
        if i == self.length - 1:
            return int(self.Carr[c + 1] - self.Carr[c])
        if i < 0:
            return 0
        k = i // C.OCC_INTERVAL
        base = k * C.OCC_INTERVAL
        cnt = int(np.count_nonzero(self.bwt[base + 1: i + 1] == c))
        if c == 0 and base < self.sa0 <= i:
            cnt -= 1  # the sa0 row's stored 0 is not a real '$' (bwt.c:363-369)
        return int(self.occ[k, c]) + cnt

    def O_alphabet(self, i: int, inc: int) -> np.ndarray:
        """All-chars bound vector: occ[j] = C[j] + O(j, i) + inc for the
        scanned chars, with quirk Q1 semantics for B/H/V/D
        (O_alphabet, bwt.c:374-438 + get_occ_count_alphabet :689-781).

        occ[0] is unspecified (the caller never reads it); returned as 0.
        """
        out = np.zeros(16, dtype=np.int64)
        j = np.arange(1, 16)
        if i == self.length - 1:
            out[1:] = self.Carr[2:17] + inc
            return out
        if i < 0:
            out[1:] = self.Carr[1:16] + inc
            return out
        k = i // C.OCC_INTERVAL
        base = k * C.OCC_INTERVAL
        block = self.bwt[base: i + 1]
        cnt = np.bincount(block, minlength=16).astype(np.int64)
        first = int(self.bwt[base])
        out[1:] = self.Carr[1:16] + inc
        for jj in range(1, 16):
            if jj in _SKIP:
                # no checkpoint/in-block count; only the double-count
                # decrement of the checkpoint's first char leaks through
                out[jj] -= (first == jj)
            else:
                out[jj] += self.occ[k, jj] + cnt[jj] - (first == jj)
        return out

    def O_actg_alphabet(self, i: int, inc: int) -> np.ndarray:
        """ACGT-only bound vector for single-genome mode, slots 1..4 = A,G,C,T
        (O_actg_alphabet, bwt.c:440-463 + get_occ_count_actg :647-687)."""
        out = np.zeros(5, dtype=np.int64)
        gray = [int(C.NT4_GRAY[b]) for b in range(4)]  # A,G,C,T orders
        if i == self.length - 1:
            for s, g in enumerate(gray):
                out[s + 1] = self.Carr[g + 1] + inc
            return out
        if i < 0:
            for s, g in enumerate(gray):
                out[s + 1] = self.Carr[g] + inc
            return out
        k = i // C.OCC_INTERVAL
        base = k * C.OCC_INTERVAL
        block = self.bwt[base: i + 1]
        cnt = np.bincount(block, minlength=16).astype(np.int64)
        first = int(self.bwt[base])
        for s, g in enumerate(gray):
            out[s + 1] = (self.Carr[g] + self.occ[k, g] + inc + cnt[g]
                          - (first == g))
        return out


def unpack_words(words: np.ndarray, length: int) -> np.ndarray:
    """Inverse of pack_words.  MSB-first nibbles == big-endian byte order,
    so a >u4 byte view + nibble split is the whole job (the obvious
    broadcasted-shift formulation is ~1000x slower in numpy)."""
    b = words.astype(">u4").view(np.uint8)
    out = np.empty(b.size * 2, dtype=np.uint8)
    out[0::2] = b >> 4
    out[1::2] = b & 0x0F
    return out[:length]
