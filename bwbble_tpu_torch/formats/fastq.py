"""FASTQ reader producing fixed-shape batches for the device engines.

Behavior mirrors `fastq2reads` (mg-aligner/io.c:410-515): reads are
nt4-encoded (A=0, G=1, C=2, T=3, everything else N=4) and the nt4 reverse
complement is precomputed.  Unlike the reference's per-read heap structs, the
output is a struct-of-arrays with static shapes so batches can be shipped to
the device directly: seq/rc int8 [N, max_len] padded with N, plus lengths.

Reads longer than 255 bp are rejected explicitly (the reference silently
corrupts state beyond 255 — quirk Q5, align.h:103-118).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from bwbble_tpu_torch import constants as C


@dataclasses.dataclass
class Reads:
    names: list[str]
    seq: np.ndarray     # int8 [N, max_len], nt4 codes, padded with 4 (N)
    rc: np.ndarray      # int8 [N, max_len], nt4 reverse complement, padded
    qual: list[bytes]
    lengths: np.ndarray  # int32 [N]

    @property
    def count(self) -> int:
        return len(self.names)

    @property
    def max_len(self) -> int:
        return int(self.seq.shape[1]) if self.count else 0


def parse_fastq_bytes(data: bytes) -> Reads:
    names: list[str] = []
    seqs: list[bytes] = []
    quals: list[bytes] = []
    pos = 0
    n = len(data)
    while True:
        at = data.find(b"@", pos)
        if at < 0:
            break
        nl = data.find(b"\n", at)
        if nl < 0:
            break
        name = data[at + 1:nl][:256]
        # sequence line
        snl = data.find(b"\n", nl + 1)
        if snl < 0:
            raise ValueError("FASTQ truncated in sequence line")
        seq = data[nl + 1:snl].rstrip(b"\r")
        # '+' separator line
        plus = data.find(b"+", snl)
        if plus < 0:
            raise ValueError("FASTQ record missing '+' line")
        pnl = data.find(b"\n", plus)
        if pnl < 0:
            raise ValueError("FASTQ truncated in '+' line")
        qnl = data.find(b"\n", pnl + 1)
        if qnl < 0:
            qnl = n
        qual = data[pnl + 1:qnl].rstrip(b"\r")
        if len(qual) != len(seq):
            raise ValueError(
                "The number of quality score symbols does not match the "
                "length of the read sequence.")
        if len(seq) > C.MAX_READ_LEN:
            raise ValueError(
                f"read '{name.decode(errors='replace')}' is {len(seq)} bp; "
                f"max supported read length is {C.MAX_READ_LEN}")
        names.append(name.decode("ascii", errors="replace"))
        seqs.append(seq)
        quals.append(qual)
        pos = qnl + 1
        if pos >= n:
            break

    count = len(names)
    max_len = max((len(s) for s in seqs), default=0)
    seq_arr = np.full((count, max_len), C.NT4_N, dtype=np.int8)
    rc_arr = np.full((count, max_len), C.NT4_N, dtype=np.int8)
    lengths = np.zeros(count, dtype=np.int32)
    for i, s in enumerate(seqs):
        codes = C.NT4_TABLE[np.frombuffer(s, dtype=np.uint8)]
        seq_arr[i, :len(s)] = codes
        rc_arr[i, :len(s)] = C.NT4_COMPLEMENT[codes[::-1]]
        lengths[i] = len(s)
    return Reads(names=names, seq=seq_arr, rc=rc_arr, qual=quals, lengths=lengths)


def read_fastq(path: str) -> Reads:
    with open(path, "rb") as f:
        data = f.read()
    from bwbble_tpu_torch.native import get_native
    nat = get_native()
    if nat is not None:
        parsed = nat.parse_fastq(data)
        if parsed is not None:
            seq, rc, lengths, name_off, name_len, qual_off = parsed
            names = [data[o:o + l].decode("ascii", errors="replace")
                     for o, l in zip(name_off, name_len)]
            quals = [data[o:o + n] for o, n in zip(qual_off, lengths)]
            if lengths.size and int(lengths.max()) > C.MAX_READ_LEN:
                pass  # fall through to the Python parser's error message
            else:
                return Reads(names=names, seq=seq, rc=rc, qual=quals,
                             lengths=lengths)
    return parse_fastq_bytes(data)


def parse_read_mapping(name: str) -> dict:
    """Parse wgsim-style simulated-truth read names (io.c:529-562).

    Format: ``chr_lpos_rpos_strand_mpos1_..._mposn`` (1-based positions).
    """
    tokens = name.split("_")
    out = {"ref_pos_l": 0, "ref_pos_r": 0, "strand": 0, "mref_pos": []}
    for idx, tok in enumerate(tokens):
        if idx == 1:
            out["ref_pos_l"] = _lead_int(tok)
        elif idx == 2:
            out["ref_pos_r"] = _lead_int(tok)
        elif idx == 3:
            out["strand"] = 0 if tok == "nm" else 1
        elif idx > 3:
            out["mref_pos"].append(_lead_int(tok))
    return out


def _lead_int(tok: str) -> int:
    """Integer prefix of a token (sscanf %llu semantics)."""
    i = 0
    while i < len(tok) and tok[i].isdigit():
        i += 1
    return int(tok[:i]) if i else 0
