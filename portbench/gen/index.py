"""The `.bwt` of a world: a frozen copy of the host index build
(`encode_fasta` of bwbble_tpu_torch/formats/fasta.py, `FMIndex.build`,
`FMIndex.store` and `pack_words` of index/fmindex.py), byte-compatible
with the reference's store_bwt (bwt.c:66-82)."""

from __future__ import annotations

import numpy as np

from portbench.gen.native import Sais
from portbench.reference import constants as C


def encode_fasta(fasta_bytes: bytes) -> np.ndarray:
    """Multi-FASTA text -> the fwd + IUPAC reverse-complement Gray-order
    code sequence, a '$' (code 0) after each sequence (io.c:190-321)."""
    if not fasta_bytes.startswith(b">"):
        raise ValueError("not a FASTA file (missing '>' header)")
    chunks = []
    for block in fasta_bytes[1:].split(b"\n>"):
        nl = block.find(b"\n")
        if nl < 0:
            raise ValueError("FASTA record with no sequence data")
        body = block[nl + 1:].translate(None, delete=b"\n")
        upper = np.frombuffer(body, dtype=np.uint8).copy()
        lower = (upper >= ord("a")) & (upper <= ord("z"))
        upper[lower] -= ord("a") - ord("A")
        chunks.append(np.concatenate([C.NT16_TABLE[upper],
                                      np.zeros(1, dtype=np.uint8)]))
    fwd = np.concatenate(chunks)
    return np.concatenate([fwd, C.IUPAC_COMPL[fwd[::-1]]])


def pack_words(codes: np.ndarray) -> np.ndarray:
    """4-bit pack, 8 chars per uint32, MSB-first (pack_word, io.c:590-609)."""
    n = codes.shape[0]
    padded = np.zeros(-(-n // 8) * 8, dtype=np.uint32)
    padded[:n] = codes
    padded = padded.reshape(-1, 8)
    shifts = np.uint32(32 - 4 * (np.arange(8, dtype=np.uint32) + 1))
    return (padded << shifts).sum(axis=1, dtype=np.uint32)


def build_bwt(fasta_path: str, bwt_path: str, build_dir: str) -> int:
    """Index `fasta_path` into `bwt_path` (construct_bwt, bwt.c:161-218);
    returns the BWT length."""
    with open(fasta_path, "rb") as f:
        seq = encode_fasta(f.read())
    sais = Sais(build_dir)
    n = int(seq.shape[0])
    length = n + 1
    full_sa = np.concatenate([np.array([n], dtype=np.int64),
                              sais.suffix_array(seq)])
    bwt = np.where(full_sa == 0, np.uint8(0),
                   seq[(full_sa - 1) % max(n, 1)]).astype(np.uint8)
    sa0 = int(np.nonzero(full_sa == 0)[0][0])
    counts = np.bincount(seq, minlength=16).astype(np.int64)
    carr = np.zeros(17, dtype=np.int64)
    carr[1:] = np.cumsum(counts)
    occ = sais.build_occ(bwt, sa0, C.OCC_INTERVAL)
    sa = full_sa[::C.SA_INTERVAL]
    hdr = np.array([length, -(-length // 8), sa.shape[0], occ.shape[0], sa0],
                   dtype="<u8")
    with open(bwt_path, "wb") as f:
        f.write(hdr.tobytes())
        f.write(carr.astype("<u8").tobytes())
        f.write(pack_words(bwt).tobytes())
        f.write(occ.astype("<u8").tobytes())
        f.write(sa.astype("<u8").tobytes())
    return length
