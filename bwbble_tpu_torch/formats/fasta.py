"""FASTA -> multi-genome reference encoding, and `.ann`/`.ref` codecs.

Reproduces the behavior of `fasta2ref` (mg-aligner/io.c:190-321): sequences
are uppercased, nt16(Gray-order)-encoded, each followed by a '$' separator
(code 0), concatenated, and the IUPAC reverse complement of the whole
concatenation is appended so one index covers both strands.

File formats (byte-compatible with the reference):
- `.ref`: raw Gray-order code bytes of the full fwd+RC sequence (io.c:269-313)
- `.ann`: text; first line "<fwd_len>\t<num_seq>\n", then one
  "<name>\t<start>\t<end>\n" per sequence (io.c:292-296)
"""

from __future__ import annotations

import dataclasses

import numpy as np

from bwbble_tpu_torch import constants as C


@dataclasses.dataclass
class SeqAnnotation:
    name: str
    start: int   # range in the concatenated fwd genome, inclusive
    end: int     # includes the trailing '$' separator


@dataclasses.dataclass
class Annotations:
    fwd_len: int               # length of the fwd concatenation (with '$'s)
    anns: list[SeqAnnotation]

    def rname_of_pos(self, pos: int) -> tuple[int, SeqAnnotation] | None:
        """Sequence containing fwd position `pos` (align.c:566-569).

        The reference scans linearly; we binary-search (same result since
        ranges are sorted and disjoint).
        """
        lo, hi = 0, len(self.anns) - 1
        while lo <= hi:
            mid = (lo + hi) // 2
            a = self.anns[mid]
            if pos < a.start:
                hi = mid - 1
            elif pos > a.end:
                lo = mid + 1
            else:
                return mid, a
        return None


def encode_fasta(fasta_bytes: bytes) -> tuple[np.ndarray, Annotations]:
    """Encode multi-FASTA text into the fwd+RC Gray-order code sequence.

    Returns (codes uint8 array of length 2*fwd_len, Annotations).
    """
    if not fasta_bytes.startswith(b">"):
        raise ValueError("not a FASTA file (missing '>' header)")
    anns: list[SeqAnnotation] = []
    chunks: list[np.ndarray] = []
    total = 0
    # split on '>' at line starts
    for block in fasta_bytes[1:].split(b"\n>"):
        nl = block.find(b"\n")
        if nl < 0:
            raise ValueError("FASTA record with no sequence data")
        name = block[:nl].decode("ascii", errors="replace")[:256]
        # the reference skips only '\n' inside sequence data (io.c:251); any
        # other character (incl. '\r') is encoded through the nt16 table
        body = block[nl + 1:].translate(None, delete=b"\n")
        upper = np.frombuffer(body, dtype=np.uint8).copy()
        lower = (upper >= ord("a")) & (upper <= ord("z"))
        upper[lower] -= ord("a") - ord("A")
        codes = C.NT16_TABLE[upper]
        codes = np.concatenate([codes, np.zeros(1, dtype=np.uint8)])  # '$'
        sub_len = codes.shape[0]
        anns.append(SeqAnnotation(name=name, start=total, end=total + sub_len - 1))
        chunks.append(codes)
        total += sub_len
    fwd = np.concatenate(chunks)
    rc = C.IUPAC_COMPL[fwd[::-1]]
    return np.concatenate([fwd, rc]), Annotations(fwd_len=total, anns=anns)


def fasta2ref(fasta_path: str, ref_path: str | None, ann_path: str | None
              ) -> tuple[np.ndarray, Annotations]:
    """Read a FASTA file; write `.ref`/`.ann`; return codes + annotations."""
    with open(fasta_path, "rb") as f:
        codes, ann = encode_fasta(f.read())
    if ref_path is not None:
        with open(ref_path, "wb") as f:
            f.write(codes.tobytes())
    if ann_path is not None:
        write_ann(ann_path, ann)
    return codes, ann


def write_ann(path: str, ann: Annotations) -> None:
    with open(path, "w") as f:
        f.write(f"{ann.fwd_len}\t{len(ann.anns)}\n")
        for a in ann.anns:
            f.write(f"{a.name}\t{a.start}\t{a.end}\n")


def read_ann(path: str) -> Annotations:
    """Parse `.ann` (annf2ann, io.c:324-349)."""
    with open(path) as f:
        first = f.readline().rstrip("\n").split("\t")
        fwd_len, num = int(first[0]), int(first[1])
        anns = []
        for _ in range(num):
            line = f.readline().rstrip("\n")
            name, start, end = line.rsplit("\t", 2)
            anns.append(SeqAnnotation(name=name, start=int(start), end=int(end)))
    return Annotations(fwd_len=fwd_len, anns=anns)


def read_ref(path: str) -> np.ndarray:
    """Load the raw code sequence of a `.ref` file (ref2seq, io.c:158-185)."""
    with open(path, "rb") as f:
        return np.frombuffer(f.read(), dtype=np.uint8)


# ------------------------------------------------- legacy 4-bit `.pac` codec
#
# The reference's earlier on-disk form (fasta2pac/pac2seq, io.c:32-156 and
# io.c:358-399): fwd-only codes packed two per byte (first char in the high
# nibble), with one trailing byte holding fwd_len % 2 so the unpacker can
# recover the exact length.  Dead in the reference pipeline (declared in
# io.h:211-212, never called) but part of its API surface.

def pack_codes(codes: np.ndarray) -> bytes:
    """4-bit-pack a code sequence, high nibble first (pack_byte, io.c:632)."""
    n = codes.shape[0]
    padded = np.zeros((n + 1) // 2 * 2, dtype=np.uint8)
    padded[:n] = codes
    return ((padded[0::2] << 4) | padded[1::2]).tobytes()


def unpack_codes(packed: np.ndarray, length: int) -> np.ndarray:
    """Inverse of pack_codes (unpack_byte, io.c:653)."""
    out = np.empty(packed.shape[0] * 2, dtype=np.uint8)
    out[0::2] = packed >> 4
    out[1::2] = packed & 0x0F
    return out[:length]


def fasta2pac(fasta_path: str, pac_path: str, ann_path: str | None
              ) -> Annotations:
    """FASTA -> `.pac` + `.ann` (fasta2pac, io.c:32-156): fwd concatenation
    only (no reverse complement), '$' after each sequence, 4-bit packed,
    final byte = fwd_len % 2."""
    with open(fasta_path, "rb") as f:
        codes, ann = encode_fasta(f.read())
    fwd = codes[:ann.fwd_len]
    with open(pac_path, "wb") as f:
        f.write(pack_codes(fwd))
        f.write(bytes([ann.fwd_len % 2]))
    if ann_path is not None:
        write_ann(ann_path, ann)
    return ann


def pac2seq(pac_path: str) -> np.ndarray:
    """`.pac` -> fwd+RC code sequence (pac2seq, io.c:358-399); identical to
    the codes fasta2ref would produce for the same FASTA."""
    data = np.fromfile(pac_path, dtype=np.uint8)
    if data.shape[0] < 1:
        raise ValueError(f"{pac_path}: empty .pac file")
    leftover = int(data[-1])
    length = (data.shape[0] - 1) * 2 - leftover
    if leftover not in (0, 1) or length < 0:
        raise ValueError(f"{pac_path}: corrupt .pac trailer")
    fwd = unpack_codes(data[:-1], length)
    rc = C.IUPAC_COMPL[fwd[::-1]]
    return np.concatenate([fwd, rc])
