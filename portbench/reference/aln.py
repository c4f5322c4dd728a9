"""The binary `.aln` record (alns2alnf_bin, align.c:345-382), per read:
int32 num_entries, then per alignment int32 score; uint64 L; uint64 U;
int32 num_mm; int32 num_gapo; int32 num_gape; int32 aln_length; int32
state_pairs; state_pairs * int32 of (state | count << 2), the runs taken
from the path's last element to its first.

`encode_alns` is a frozen copy of bwbble_tpu_torch/formats/aln.py's;
`read_records` cuts a file into its reads' records, byte for byte."""

from __future__ import annotations

import struct

_REC_HEAD = struct.Struct("<iQQiiii")


def encode_alns(alns) -> bytes:
    """Encode one read's alignment list."""
    out = [struct.pack("<i", len(alns))]
    for a in alns:
        out.append(_REC_HEAD.pack(a.score, a.L, a.U, a.num_mm, a.num_gapo,
                                  a.num_gape, a.aln_length))
        path = a.path[:a.aln_length]
        if a.aln_length > 0:
            runs: list[int] = []
            state = path[-1]
            count = 1
            for j in range(len(path) - 2, -1, -1):
                if path[j] == state:
                    count += 1
                else:
                    runs.append(state | (count << 2))
                    state = path[j]
                    count = 1
            runs.append(state | (count << 2))
            out.append(struct.pack("<i", len(runs)))
            out.append(struct.pack(f"<{len(runs)}i", *runs))
        else:
            out.append(struct.pack("<i", 0))
    return b"".join(out)


def read_records(data: bytes) -> list[tuple[int, int, list[int]]]:
    """Each read's record in `data`: (offset, length in bytes, the
    aln_length of each alignment).  Raises ValueError on a cut record."""
    out = []
    pos, n = 0, len(data)
    while pos < n:
        if pos + 4 > n:
            raise ValueError(f"`.aln` cut at byte {pos}")
        start = pos
        (num,) = struct.unpack_from("<i", data, pos)
        pos += 4
        lens = []
        for _ in range(num):
            if pos + _REC_HEAD.size + 4 > n:
                raise ValueError(f"`.aln` cut at byte {pos}")
            lens.append(_REC_HEAD.unpack_from(data, pos)[6])
            (pairs,) = struct.unpack_from("<i", data, pos + _REC_HEAD.size)
            pos += _REC_HEAD.size + 4 + 4 * pairs
        if pos > n:
            raise ValueError(f"`.aln` cut at byte {start}")
        out.append((start, pos - start, lens))
    return out
