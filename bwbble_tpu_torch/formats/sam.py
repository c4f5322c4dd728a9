"""SAM emission, byte-compatible with alns2sam/print_aln2sam
(align.c:494-652)."""

from __future__ import annotations

from typing import TextIO

from bwbble_tpu_torch import constants as C
from bwbble_tpu_torch.align.eval import ALN_NOMATCH, ReadHit
from bwbble_tpu_torch.formats.fasta import Annotations

SAM_FSU = 4    # self-unmapped
SAM_FSR = 16   # self on the reverse strand


def write_sam_header(f: TextIO, ann: Annotations) -> None:
    for a in ann.anns:
        f.write(f"@SQ\tSN:{a.name}\tLN:{a.end - a.start + 1}\n")
    f.write("@PG\tID:bwbble\tPN:bwbble\tVN:0.1-r01\n")


def _cigar_string(path: bytes) -> str:
    """CIGAR RLE over the path scanned from its end to its start
    (align.c:585-607)."""
    out = []
    i = len(path) - 1
    while i >= 0:
        j = i
        while j - 1 >= 0 and path[j - 1] == path[i]:
            j -= 1
        out.append(f"{i - j + 1}{'MID'[path[i]]}")
        i = j - 1
    return "".join(out)


def format_sam_record(name: str, seq_nt4, rc_nt4, qual: bytes, length: int,
                      hit: ReadHit, ann: Annotations) -> str:
    """One SAM line for a read (print_aln2sam, align.c:562-652)."""
    if hit.aln_type != ALN_NOMATCH:
        found = ann.rname_of_pos(hit.aln_pos)
        if found is None:
            raise ValueError(f"aligned position {hit.aln_pos} is outside "
                             "every annotated sequence range")
        _, a = found
        flag = SAM_FSR if hit.aln_strand else 0
        pos = hit.aln_pos - a.start + 1
        path = hit.path[::-1] if hit.aln_strand else hit.path
        cigar = _cigar_string(path)
        codes = rc_nt4 if hit.aln_strand else seq_nt4
        seq = "".join(C.NT4_CHAR[int(codes[i])] for i in range(length))
        if qual:
            q = qual[::-1] if hit.aln_strand else qual
            qstr = q.decode("ascii")
        else:
            qstr = "*"
        return (f"{name}\t{flag}\t{a.name}\t{pos}\t{hit.mapq}\t{cigar}"
                f"\t*\t0\t0\t{seq}\t{qstr}\n")
    # unmapped (aln_strand is always 0 here, so no seq/qual reversal)
    seq = "".join(C.NT4_CHAR[int(seq_nt4[i])] for i in range(length))
    qstr = qual.decode("ascii") if qual else "*"
    return f"{name}\t{SAM_FSU}\t*\t0\t0\t*\t*\t0\t0\t{seq}\t{qstr}\n"
