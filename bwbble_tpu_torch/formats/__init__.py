"""Byte-compatible codecs for the reference's on-disk formats.

`.ann`/`.ref` (io.c:190-349), `.bwt` (bwt.c:66-125), `.aln` (align.c:345-483),
FASTQ (io.c:410-515), SAM (align.c:494-652).
"""
