"""FM-index over the 16-letter multi-genome alphabet.

Host-side model of the reference's `bwt_t` (mg-aligner/bwt.h:19-40) with a
byte-compatible `.bwt` serialization (bwt.c:66-125) and numpy implementations
of every query op (B, C, O, O_alphabet, O_actg_alphabet, SA, invPsi;
bwt.c:311-781).  These numpy ops are the *gold model*: they replicate the
reference's exact semantics — including quirk Q1 (the bulk 16-char scan never
counts the 3-base codes B/H/V/D, bwt.c:698-734) and the checkpoint first-char
decrement (bwt.c:653,780) — and serve as the oracle for the device kernels in
bwbble_tpu_torch.engine.

Layout differences from the reference are intentional: on the host the BWT is
kept as one code byte per position (the 4-bit packing exists only in the
`.bwt` codec), and the device layout (bit-plane words) lives in
bwbble_tpu_torch.engine.device_index.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from bwbble_tpu_torch import constants as C
from bwbble_tpu_torch.index.suffix_array import suffix_array

_HDR_DTYPE = np.dtype("<u8")
_SKIP = C.SKIPPED_ORDERS


@dataclasses.dataclass
class FMIndex:
    length: int          # BWT length = reference length + 1 (virtual '$' row)
    sa0: int             # row whose BWT char is the virtual '$'
    bwt: np.ndarray      # uint8 [length] Gray-order codes (code 0 at sa0)
    Carr: np.ndarray     # int64 [17] prefix counts, excludes the sa0 row
    occ: np.ndarray      # int64 [num_occ, 16] checkpoints every OCC_INTERVAL
    sa: np.ndarray       # int64 [num_sa] samples every SA_INTERVAL
    _planes: np.ndarray | None = dataclasses.field(
        default=None, repr=False, compare=False)
    _fused: np.ndarray | None = dataclasses.field(
        default=None, repr=False, compare=False)

    # ------------------------------------------------------------------ build

    @classmethod
    def build(cls, seq: np.ndarray, full_sa: np.ndarray | None = None
              ) -> "FMIndex":
        """Build from a Gray-order code sequence (construct_bwt, bwt.c:161-218).

        `full_sa` optionally supplies the (n+1)-row suffix array (row 0 = n,
        the virtual total-'$'), e.g. from the external 40-bit eSAIS path.
        """
        seq = np.ascontiguousarray(seq, dtype=np.uint8)
        n = int(seq.shape[0])
        length = n + 1
        if full_sa is None:
            sa_body = suffix_array(seq)
            full_sa = np.concatenate([np.array([n], dtype=np.int64), sa_body])
        full_sa = np.ascontiguousarray(full_sa, dtype=np.int64)
        if full_sa.shape[0] != length:
            raise ValueError("full_sa must have length n+1")

        # BWT: char preceding each suffix; the row with SA==0 holds the
        # virtual '$' (code 0) and is remembered as sa0 (is.c:222-235)
        bwt = np.where(full_sa == 0, np.uint8(0),
                       seq[(full_sa - 1) % max(n, 1)]).astype(np.uint8)
        sa0 = int(np.nonzero(full_sa == 0)[0][0])

        # C: counts over the real sequence chars only (compute_C, bwt.c:266-277)
        counts = np.bincount(seq, minlength=16).astype(np.int64)
        Carr = np.zeros(17, dtype=np.int64)
        Carr[1:] = np.cumsum(counts)

        occ = cls._build_occ(bwt, sa0)
        sa_samples = full_sa[::C.SA_INTERVAL].copy()
        return cls(length=length, sa0=sa0, bwt=bwt, Carr=Carr, occ=occ,
                   sa=sa_samples)

    @staticmethod
    def _build_occ(bwt: np.ndarray, sa0: int) -> np.ndarray:
        """Checkpoints: occ[k, c] = #c in bwt[0 .. k*OCC_INTERVAL], skipping
        the sa0 row (compute_O, bwt.c:280-291)."""
        from bwbble_tpu_torch.native import get_native
        nat = get_native()
        if nat is not None:
            return nat.build_occ(bwt, sa0, C.OCC_INTERVAL)
        length = bwt.shape[0]
        num_occ = -(-length // C.OCC_INTERVAL)
        occ = np.zeros((num_occ, 16), dtype=np.int64)
        ck = np.arange(num_occ, dtype=np.int64) * C.OCC_INTERVAL
        for c in range(16):
            cs = np.cumsum(bwt == c, dtype=np.int64)
            occ[:, c] = cs[ck]
        # the sa0 row holds code 0 but must not be counted
        occ[ck >= sa0, 0] -= 1
        return occ

    # ------------------------------------------------------------- .bwt codec

    def store(self, path: str) -> None:
        """Serialize byte-compatibly with store_bwt (bwt.c:66-82)."""
        num_words = -(-self.length // 8)
        header = np.array(
            [self.length, num_words, self.sa.shape[0], self.occ.shape[0],
             self.sa0], dtype=_HDR_DTYPE)
        with open(path, "wb") as f:
            f.write(header.tobytes())
            f.write(self.Carr.astype(_HDR_DTYPE).tobytes())
            f.write(pack_words(self.bwt).tobytes())
            f.write(self.occ.astype(_HDR_DTYPE).tobytes())
            f.write(self.sa.astype(_HDR_DTYPE).tobytes())

    @classmethod
    def load(cls, path: str, load_sa: bool = True) -> "FMIndex":
        """Deserialize (load_bwt, bwt.c:90-125)."""
        import os
        size = os.path.getsize(path)
        if size < (5 + 17) * 8:
            raise ValueError(
                f"{path}: not a .bwt file (only {size} bytes; "
                "truncated or wrong path?)")
        with open(path, "rb") as f:
            hdr = np.frombuffer(f.read(5 * 8), dtype=_HDR_DTYPE)
            length, num_words, num_sa, num_occ, sa0 = (int(x) for x in hdr)
            Carr = np.frombuffer(f.read(17 * 8), dtype=_HDR_DTYPE).astype(np.int64)
            words = np.frombuffer(f.read(num_words * 4), dtype="<u4")
            # <u8 and int64 share layout for all stored values (< 2^63):
            # view instead of astype (the copies were ~35 s at chr21 scale)
            occ = np.frombuffer(f.read(num_occ * 16 * 8), dtype=_HDR_DTYPE
                                ).view(np.int64).reshape(num_occ, 16)
            if load_sa:
                sa = np.frombuffer(f.read(num_sa * 8), dtype=_HDR_DTYPE
                                   ).view(np.int64)
            else:
                sa = np.zeros(0, dtype=np.int64)
        bwt = unpack_words(words, length)
        return cls(length=length, sa0=sa0, bwt=bwt, Carr=Carr, occ=occ, sa=sa)

    # ------------------------------------------------------------ query model

    def B(self, i: int) -> int:
        return int(self.bwt[i])

    def C_(self, c: int) -> int:
        return int(self.Carr[c])

    def bit_planes(self) -> np.ndarray:
        """uint64 [4, nwords] BWT bit planes (bit t of the code at
        position p is planes[t, p // 64] bit p % 64); built once and
        cached — the native D-bound scanner's rank substrate."""
        if self._planes is None:
            n = self.length
            nwords = -(-n // 64)
            pad = np.zeros(nwords * 64, dtype=np.uint8)
            pad[:n] = self.bwt
            planes = np.zeros((4, nwords), dtype=np.uint64)
            for t in range(4):
                # little-endian packbits + little-endian u8 view puts bit
                # p%64 of word p//64 at position p — no 64x blow-up
                planes[t] = np.packbits((pad >> t) & 1,
                                        bitorder="little").view("<u8")
            object.__setattr__(self, "_planes", planes)
        return self._planes

    def fused_planes(self) -> np.ndarray | None:
        """uint64 [num_occ, 16] fused rank rows for the native engines:
        row k = the 8 plane words covering block k's 128 positions
        (p-major: p0w0,p0w1,p1w0,...) followed by occ[k, 0..15] packed as
        uint32 pairs.  One rank query touches one 128-byte row instead of
        ~5 scattered cache lines (4 plane words + a 128-byte row of the
        [num_occ,16] int64 occ table) — the native DFS is DRAM-latency-
        bound, not compute-bound.  None when counts exceed uint32 (large
        int64 indexes keep the split-table path)."""
        if self.length >= (1 << 31):
            return None
        if self._fused is None:
            planes = self.bit_planes()
            nb = self.occ.shape[0]
            pw = np.zeros((4, 2 * nb), dtype=np.uint64)
            pw[:, :planes.shape[1]] = planes
            fused = np.empty((nb, 16), dtype=np.uint64)
            fused[:, 0:8] = pw.reshape(4, nb, 2).transpose(1, 0, 2) \
                              .reshape(nb, 8)
            fused[:, 8:16] = np.ascontiguousarray(
                self.occ.astype("<u4")).view("<u8")
            object.__setattr__(self, "_fused", fused)
        return self._fused

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

    def invPsi(self, i: int) -> int:
        """LF-mapping step (invPsi, bwt.c:311-317)."""
        if i == self.sa0:
            return 0
        c = int(self.bwt[i])
        return int(self.Carr[c]) + self.O(c, i)

    def SA(self, i: int) -> int:
        """Suffix-array value via sampled SA + invPsi walk (bwt.c:320-329)."""
        j = 0
        while i % C.SA_INTERVAL != 0:
            i = self.invPsi(i)
            j += 1
        return int((self.sa[i // C.SA_INTERVAL] + j) % self.length)


def pack_words(codes: np.ndarray) -> np.ndarray:
    """4-bit pack, 8 chars per uint32, MSB-first (pack_word, io.c:590-609)."""
    n = codes.shape[0]
    num_words = -(-n // 8)
    padded = np.zeros(num_words * 8, dtype=np.uint32)
    padded[:n] = codes
    padded = padded.reshape(num_words, 8)
    shifts = np.uint32(32 - 4 * (np.arange(8, dtype=np.uint32) + 1))
    return (padded << shifts).sum(axis=1, dtype=np.uint32)


def unpack_words(words: np.ndarray, length: int) -> np.ndarray:
    """Inverse of pack_words.  MSB-first nibbles == big-endian byte order,
    so a >u4 byte view + nibble split is the whole job (the obvious
    broadcasted-shift formulation is ~1000x slower in numpy)."""
    b = words.astype(">u4").view(np.uint8)
    out = np.empty(b.size * 2, dtype=np.uint8)
    out[0::2] = b >> 4
    out[1::2] = b & 0x0F
    return out[:length]
