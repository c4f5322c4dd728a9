"""Alphabet constants for the 16-letter IUPAC multi-genome encoding.

Frozen copy of bwbble_tpu_torch/constants.py for the benchmark's world
builder and plain reference, which import nothing of the program.

The reference (mg-aligner/io.h:26-149) orders the 16 IUPAC symbols by the
binary-reflected Gray code of their 4-bit base bitmask (bit 8 = A, 4 = C,
2 = G, 1 = T; mask 0 = the '$' separator).  Every table here is *derived*
from that definition rather than transcribed, and validated against the
reference semantics by the repository's tests/test_constants.py.

Encodings used throughout the framework:

- "gray order" (0..15): the symbol's rank in Gray-code order.  This is the
  code stored in the reference `.ref` files and the BWT (io.h:28).
- "mask" (0..15): the 4-bit base bitmask (io.h:29 `grayVal`).
- "nt4" (0..4): read-base encoding A=0, G=1, C=2, T=3, N=4 (io.h:112).
"""

from __future__ import annotations

import numpy as np

ALPHABET_SIZE = 16

# Gray code value of index i (binary-reflected): mask of the i-th symbol.
# Equivalent to the reference's grayVal table (io.h:29).
GRAY_VAL = np.array([i ^ (i >> 1) for i in range(16)], dtype=np.uint8)

# mask -> gray order (inverse permutation of GRAY_VAL)
MASK_TO_ORDER = np.zeros(16, dtype=np.uint8)
for _i in range(16):
    MASK_TO_ORDER[GRAY_VAL[_i]] = _i

_BIT_A, _BIT_C, _BIT_G, _BIT_T = 8, 4, 2, 1

# mask -> IUPAC ASCII letter ('$' for the empty mask)
_MASK_TO_CHAR = {
    0: "$",
    _BIT_A: "A", _BIT_C: "C", _BIT_G: "G", _BIT_T: "T",
    _BIT_A | _BIT_C: "M", _BIT_A | _BIT_G: "R", _BIT_A | _BIT_T: "W",
    _BIT_C | _BIT_G: "S", _BIT_C | _BIT_T: "Y", _BIT_G | _BIT_T: "K",
    _BIT_A | _BIT_C | _BIT_G: "V", _BIT_A | _BIT_C | _BIT_T: "H",
    _BIT_A | _BIT_G | _BIT_T: "D", _BIT_C | _BIT_G | _BIT_T: "B",
    _BIT_A | _BIT_C | _BIT_G | _BIT_T: "N",
}

# gray order -> IUPAC ASCII letter (io.h:28 iupacChar)
IUPAC_CHAR = np.array([ord(_MASK_TO_CHAR[int(GRAY_VAL[i])]) for i in range(16)],
                      dtype=np.uint8)
IUPAC_CHAR_STR = "".join(chr(c) for c in IUPAC_CHAR)


def _compl_mask(mask: int) -> int:
    """Complement a base bitmask: A<->T, C<->G, i.e. reverse the 4 bits."""
    out = 0
    if mask & _BIT_A:
        out |= _BIT_T
    if mask & _BIT_T:
        out |= _BIT_A
    if mask & _BIT_C:
        out |= _BIT_G
    if mask & _BIT_G:
        out |= _BIT_C
    return out


# gray order -> gray order of the complementary symbol (io.h:32 iupacCompl)
IUPAC_COMPL = np.array(
    [MASK_TO_ORDER[_compl_mask(int(GRAY_VAL[i]))] for i in range(16)],
    dtype=np.uint8)

# gray order -> 1 if the symbol denotes >=2 bases (a SNP position; io.h:33)
IS_SNP = np.array([1 if bin(int(GRAY_VAL[i])).count("1") >= 2 else 0
                   for i in range(16)], dtype=np.uint8)

# --- nt4 read-base encoding (A=0, G=1, C=2, T=3, N=4; io.h:112-130) ---

NT4_A, NT4_G, NT4_C, NT4_T, NT4_N = 0, 1, 2, 3, 4
NT4_BASE_MASK = np.array([_BIT_A, _BIT_G, _BIT_C, _BIT_T, 15], dtype=np.uint8)

# nt4 base -> gray order of the pure-base symbol (io.h:108 nt4_gray)
NT4_GRAY = np.array([MASK_TO_ORDER[int(m)] for m in NT4_BASE_MASK], dtype=np.uint8)
# nt4 base -> its bitmask (io.h:109 nt4_gray_val)
NT4_GRAY_VAL = NT4_BASE_MASK
# nt4 base -> nt4 complement (io.h:110)
NT4_COMPLEMENT = np.array([NT4_T, NT4_C, NT4_G, NT4_A, NT4_N], dtype=np.uint8)

# ASCII -> nt4 (io.h:113-130); everything unknown decodes to N
NT4_TABLE = np.full(256, NT4_N, dtype=np.uint8)
for _b, _ch in [(NT4_A, "Aa"), (NT4_G, "Gg"), (NT4_C, "Cc"), (NT4_T, "Tt")]:
    for _c in _ch:
        NT4_TABLE[ord(_c)] = _b

# ASCII -> gray order (io.h:132-149 nt16_table); unknown -> N's order
ORDER_N = int(MASK_TO_ORDER[15])        # == 10
ORDER_DOLLAR = 0
NT16_TABLE = np.full(256, ORDER_N, dtype=np.uint8)
for _i in range(16):
    _ch = chr(int(IUPAC_CHAR[_i]))
    NT16_TABLE[ord(_ch)] = _i
    if _ch.isalpha():
        NT16_TABLE[ord(_ch.lower())] = _i

# For each nt4 base, the gray orders of the (non-N) IUPAC symbols whose mask
# contains that base, in increasing gray order (io.h:102-106 nucl_bases_table).
BASES_PER_NUCLEOTIDE = 7
NUCL_BASES = np.zeros((4, BASES_PER_NUCLEOTIDE), dtype=np.uint8)
for _b in range(4):
    _orders = sorted(
        int(MASK_TO_ORDER[m]) for m in range(1, 16)
        if (m & int(NT4_BASE_MASK[_b])) and m != 15)
    assert len(_orders) == BASES_PER_NUCLEOTIDE
    NUCL_BASES[_b] = _orders

# Gray orders skipped by the reference's bulk occurrence scan: the three-base
# IUPAC codes B, H, V, D never get in-block counts in the inexact search
# (quirk Q1; mg-aligner/bwt.c:698-734 commented-out XOR lines).  Kept as data
# so the parity behavior is explicit and testable.
SKIPPED_ORDERS = tuple(sorted(int(MASK_TO_ORDER[m]) for m in (7, 11, 13, 14)))
assert SKIPPED_ORDERS == (5, 9, 11, 13)

# Membership matrix: MATCH_MATRIX[nt4, order] = 1 iff the pure base is
# contained in the symbol's mask (the match test of inexact_match.c:472).
MATCH_MATRIX = np.zeros((5, 16), dtype=np.uint8)
for _b in range(5):
    for _j in range(16):
        MATCH_MATRIX[_b, _j] = 1 if (int(NT4_BASE_MASK[_b]) & int(GRAY_VAL[_j])) else 0

# SAM sequence alphabet in nt4 order (align.c:615 "AGCTN")
NT4_CHAR = "AGCTN"

# Index layout parameters (bwt.h:14-16)
OCC_INTERVAL = 128
SA_INTERVAL = 32

# Alignment path states (align.h:16-18)
STATE_M, STATE_I, STATE_D = 0, 1, 2

ALN_PATH_MAX = 256          # align.h:21 — reads are capped at 255 chars (Q5)
MAX_READ_LEN = 255
