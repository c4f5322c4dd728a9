"""Binary `.aln` alignment-record codec (byte-compatible).

Write format (alns2alnf_bin, align.c:345-382), per read:
  int32 num_entries, then per alignment:
  int32 score; uint64 L; uint64 U; int32 num_mm; int32 num_gapo;
  int32 num_gape; int32 aln_length; int32 state_pairs;
  state_pairs * int32 of (state | count << 2)
The RLE walks the in-memory path from its last element to its first, so the
on-disk run order is the *reverse* of the in-search path; the reader
(alnsf2alns_bin, align.c:430-483) expands runs in disk order, i.e. returns
the reversed path.  SAM generation operates on that reversed order.
"""

from __future__ import annotations

import struct

from bwbble_tpu_torch.gold.engine import Aln

_REC_HEAD = struct.Struct("<iQQiiii")


def encode_alns(alns: list[Aln]) -> bytes:
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


def write_aln_file(path: str, per_read_alns: list[list[Aln]]) -> None:
    with open(path, "wb") as f:
        for alns in per_read_alns:
            f.write(encode_alns(alns))


def encode_alns_text(alns: list[Aln]) -> bytes:
    """Text `.aln` record (alns2alnf, align.c:332-343): header fields tab-
    separated, then the path bytes in reverse (disk) order, each raw state
    byte followed by a space."""
    out = [f"{len(alns)}\n".encode()]
    for a in alns:
        out.append(f"{a.score}\t{a.L}\t{a.U}\t{a.num_mm}\t{a.num_gapo}\t"
                   f"{a.num_gape}\t{a.aln_length}\t".encode())
        path = a.path[:a.aln_length]
        out.append(b" ".join(bytes([s]) for s in reversed(path)))
        if path:
            out.append(b" ")
        out.append(b"\n")
    return b"".join(out)


def write_aln_text_file(path: str, per_read_alns: list[list[Aln]]) -> None:
    with open(path, "wb") as f:
        for alns in per_read_alns:
            f.write(encode_alns_text(alns))


def read_aln_text_file(path: str) -> list[list[Aln]]:
    """Decode the text format (alnsf2alns, align.c:391-430); paths are
    returned in disk order like the binary reader."""
    with open(path, "rb") as f:
        data = f.read()
    pos = 0
    n = len(data)
    out: list[list[Aln]] = []
    while pos < n:
        nl = data.find(b"\n", pos)
        num = int(data[pos:nl])
        pos = nl + 1
        alns: list[Aln] = []
        for _ in range(num):
            fields = []
            for _f in range(7):
                tab = data.find(b"\t", pos)
                fields.append(int(data[pos:tab]))
                pos = tab + 1
            score, L, U, mm, go, ge, alen = fields
            path = bytes(data[pos + 2 * j] for j in range(alen))
            pos += 2 * alen
            if pos < n and data[pos:pos + 1] == b"\n":
                pos += 1
            alns.append(Aln(score=score, L=L, U=U, num_mm=mm, num_gapo=go,
                            num_gape=ge, num_snps=0, aln_length=alen,
                            path=path))
        out.append(alns)
    return out


def read_aln_file(path: str) -> list[list[Aln]]:
    """Decode a `.aln` file.  Returned Aln.path is in *disk order* (reversed
    search path), matching alnsf2alns_bin."""
    with open(path, "rb") as f:
        data = f.read()
    pos = 0
    n = len(data)
    out: list[list[Aln]] = []
    while pos + 4 <= n:
        (num,) = struct.unpack_from("<i", data, pos)
        pos += 4
        alns: list[Aln] = []
        for _ in range(num):
            score, L, U, mm, go, ge, alen = _REC_HEAD.unpack_from(data, pos)
            pos += _REC_HEAD.size
            (pairs,) = struct.unpack_from("<i", data, pos)
            pos += 4
            path = bytearray()
            for _j in range(pairs):
                (sp,) = struct.unpack_from("<i", data, pos)
                pos += 4
                path.extend(bytes([sp & 3]) * (sp >> 2))
            alns.append(Aln(score=score, L=L, U=U, num_mm=mm, num_gapo=go,
                            num_gape=ge, num_snps=0, aln_length=alen,
                            path=bytes(path)))
        out.append(alns)
    return out
