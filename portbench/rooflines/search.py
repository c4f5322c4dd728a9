"""The search kernel (`csrc/ring_search.cu`): the least bytes its launches
need, each byte once.  Inputs, a read the device searches: its reverse-
complement codes (int8, `read_len`), its length (int32), its D bounds
(int32 pairs, `read_len + 1` of them) and its seed's (`seed_len + 1`).
Outputs: each read's count of records (int32) and each record's L, U,
score, length, SNPs and one word packing mismatches, gap opens and gap
extensions (six int32), with its path at 2 bits a state.  The FM-index
rows the search walks are left out: which rows, and how many, depend on
the search, and their latency, not their bytes, bounds the kernel.  So
this bound reads far under 1 % of the time the launches take."""

INT = 4
RECORD_WORDS = 6


def read_bytes(read_len: int, seed_len: int) -> int:
    """Input bytes of one searched read."""
    return read_len + INT + (read_len + 1) * 2 * INT + \
        (seed_len + 1) * 2 * INT


def record_bytes(aln_lengths) -> int:
    """Output bytes of one read with alignments of these path lengths."""
    return INT + sum(RECORD_WORDS * INT + -(-int(n) // 4)
                     for n in aln_lengths)
