"""Synthetic worlds, made from seeds: the three small worlds the tests and
the on-card kernel comparison share, the chr21-scale multi-genome world of
the main path, and the easy pure-ACGT world of the fixed-batch and
single-genome paths.

Everything is generated; nothing is downloaded.
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np

from bwbble_tpu_torch import constants as C
from bwbble_tpu_torch.formats.fasta import fasta2ref
from bwbble_tpu_torch.formats.fastq import Reads, parse_fastq_bytes, read_fastq
from bwbble_tpu_torch.index.fmindex import FMIndex


def _fastq(reads: list[str]) -> Reads:
    fq = "".join(f"@r{i}\n{s}\n+\n{'I' * len(s)}\n"
                 for i, s in enumerate(reads))
    return parse_fastq_bytes(fq.encode())


def mixed_world(seed: int = 177, n_reads: int = 48, read_len: int = 32):
    """4 kbp of mostly pure bases with an IUPAC-dense tail, fwd + IUPAC
    reverse complement (as fasta2ref lays an index out), and reads with 0-2
    substitutions, some with a 1 bp deletion.  Returns (FMIndex, Reads)."""
    rng = np.random.default_rng(seed)
    seq = rng.integers(1, 16, size=4000).astype(np.uint8)
    acgt = np.array([15, 3, 7, 1], dtype=np.uint8)
    seq[:3300] = acgt[rng.integers(0, 4, size=3300)]
    seq[1600] = 0
    seq = np.concatenate([seq, C.IUPAC_COMPL[seq[::-1]]])
    idx = FMIndex.build(seq)
    reads = []
    chars = "AGCT"
    for r in range(n_reads):
        s = int(rng.integers(0, 3300 - read_len))
        frag = [chars[int(C.NT4_TABLE[C.IUPAC_CHAR[x]])]
                if C.IUPAC_CHAR[x] in b"ACGT" else "A"
                for x in seq[s:s + read_len]]
        for _ in range(int(rng.integers(0, 3))):
            frag[int(rng.integers(0, read_len))] = chars[
                int(rng.integers(0, 4))]
        if r % 11 == 5:
            p = int(rng.integers(2, read_len - 4))
            del frag[p]                      # 1 bp deletion: exercises gaps
            frag.append(chars[int(rng.integers(0, 4))])
        reads.append("".join(frag))
    return idx, _fastq(reads)


def single_genome_world(seed: int = 377, n_reads: int = 48,
                        read_len: int = 32):
    """Single-genome (`-S`) world: 4 kbp of pure bases with one N, fwd +
    reverse complement, and reads with 0-2 substitutions, one in eleven
    with a 1 bp deletion.  Returns (FMIndex, Reads)."""
    rng = np.random.default_rng(seed)
    acgt = np.asarray(C.NT4_GRAY[:4], dtype=np.uint8)
    seq = acgt[rng.integers(0, 4, size=4000)].astype(np.uint8)
    seq[1600] = 0
    seq = np.concatenate([seq, C.IUPAC_COMPL[seq[::-1]]])
    idx = FMIndex.build(seq)
    gray_to_base = {int(g): b for b, g in enumerate(C.NT4_GRAY[:4])}
    reads = []
    chars = "AGCT"
    for r in range(n_reads):
        s = int(rng.integers(0, 3900 - read_len))
        frag = [chars[gray_to_base.get(int(x), 0)]
                for x in seq[s:s + read_len]]
        for _ in range(int(rng.integers(0, 3))):
            frag[int(rng.integers(0, read_len))] = chars[
                int(rng.integers(0, 4))]
        if r % 11 == 5:
            p = int(rng.integers(2, read_len - 4))
            del frag[p]                      # 1 bp deletion: exercises gaps
            frag.append(chars[int(rng.integers(0, 4))])
        reads.append("".join(frag))
    return idx, _fastq(reads)


def iupac_dense_world(workdir: str, seed: int = 991, n_reads: int = 32,
                      read_len: int = 48):
    """Three diverged copies of a 1.5 kbp block with a second base bit
    folded into ~1/6 of the positions: exact-completion interval lists run
    far past a handful of slots here.  Returns (FMIndex, Reads)."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 4, size=1500)
    seq_blocks = []
    for rep in range(3):                             # repeats widen lists
        blk = base.copy()
        mut = rng.random(blk.size) < (0.02 * rep)
        blk[mut] = rng.integers(0, 4, size=int(mut.sum()))
        seq_blocks.append(blk)
    acgt_codes = np.array([8, 4, 2, 1], dtype=np.uint8)   # A,C,G,T masks
    codes = acgt_codes[np.concatenate(seq_blocks)]
    snp = rng.random(codes.size) < 1 / 6.0
    other = acgt_codes[rng.integers(0, 4, size=codes.size)]
    codes = np.where(snp, codes | other, codes).astype(np.uint8)
    mask_to_char = {1: "T", 2: "G", 4: "C", 8: "A", 3: "K", 5: "Y",
                    6: "S", 9: "W", 10: "R", 12: "M", 7: "B", 11: "D",
                    13: "H", 14: "V", 15: "N"}
    fa = os.path.join(workdir, "dense.fa")
    with open(fa, "w") as f:
        f.write(">c\n" + "".join(mask_to_char[int(m)] for m in codes) + "\n")
    out_codes, _ = fasta2ref(fa, fa + ".ref", fa + ".ann")
    idx = FMIndex.build(out_codes)
    nt4 = {0: "A", 1: "C", 2: "G", 3: "T"}
    reads = []
    for _ in range(n_reads):
        s = int(rng.integers(0, base.size - read_len))
        frag = [nt4[int(x)] for x in base[s:s + read_len]]
        for _ in range(int(rng.integers(0, 3))):
            frag[int(rng.integers(0, read_len))] = nt4[
                int(rng.integers(0, 4))]
        reads.append("".join(frag))
    return idx, _fastq(reads)


def chr21_world(workdir: str, genome_bp: int = 46_700_000,
                num_reads: int = 16_384, read_len: int = 100, log=None):
    """The main path's world, cached under `workdir`: a genome with
    diverged repeats (15% of 500 bp blocks are copies of earlier blocks at
    5% divergence, seed 11), a synthetic VCF at 1 SNP / 100 bp and 1 indel /
    1000 bp (seed 12) folded in by the native `data_prep` + `comb -w 124`
    tools (SNPs become IUPAC codes, indels appended bubble sequences), and
    `num_reads` simulated reads with Poisson(1.2) mismatches capped at 4
    and a 1-3 bp indel on 12% of them (seed 13).  Builds what is missing
    and returns the paths (fasta, fastq) of the multi-genome reference and
    the reads; the caller indexes and aligns them."""
    from bwbble_tpu_torch.testutil import (random_genome_with_repeats_fasta,
                                           simulate_reads_fastq,
                                           synthetic_vcf)
    log = log or (lambda msg: None)
    os.makedirs(workdir, exist_ok=True)
    fa = os.path.join(workdir, "genome.fa")
    vcf = os.path.join(workdir, "variants.vcf")
    mg = os.path.join(workdir, "mg.fa")
    mgb = os.path.join(workdir, "mg_bubble.fa")
    bdata = os.path.join(workdir, "bubble.data")
    fq = os.path.join(workdir, f"reads_{num_reads}.fq")
    if not os.path.exists(fa):
        random_genome_with_repeats_fasta(fa, "21", genome_bp, seed=11,
                                         repeat_frac=0.15, block=500,
                                         mut_rate=0.05)
        log("genome written")
    if not os.path.exists(vcf):
        synthetic_vcf(fa, vcf, snp_rate=0.01, indel_rate=0.001, seed=12)
        log("vcf written")
    if not os.path.exists(mgb):
        exe = mgref_binary()
        os.makedirs(os.path.join(workdir, "mg-ref-output"), exist_ok=True)
        subprocess.run([exe, "data_prep", "-c", vcf], check=True,
                       cwd=workdir, stdout=subprocess.DEVNULL)
        subprocess.run([exe, "comb", "-w", "124", fa, mg, mgb, bdata],
                       check=True, cwd=workdir, stdout=subprocess.DEVNULL)
        log("multi-genome reference written")
    if not os.path.exists(fq):
        simulate_reads_fastq(fa, fq, num_reads, read_len=read_len,
                             mm_poisson=1.2, mm_cap=4, indel_frac=0.12,
                             seed=13)
        log("reads written")
    return mgb, fq


def easy_world(workdir: str, genome_bp: int = 5_000_000,
               num_reads: int = 16_384, read_len: int = 100):
    """The easy world, cached under `workdir`: a uniform random pure-ACGT
    genome (seed 11) and `num_reads` simulated reads with 2 mismatches
    each (seed 13).  Returns the paths (fasta, fastq); the caller indexes
    and aligns them."""
    from bwbble_tpu_torch.testutil import (random_genome_fasta,
                                           simulate_reads_fastq)
    os.makedirs(workdir, exist_ok=True)
    fa = os.path.join(workdir, "bench.fa")
    fq = os.path.join(workdir, f"reads_{num_reads}.fq")
    if not os.path.exists(fa):
        random_genome_fasta(fa, {"chr1": genome_bp}, seed=11)
    if not os.path.exists(fq):
        simulate_reads_fastq(fa, fq, num_reads, read_len=read_len, num_mm=2,
                             seed=13)
    return fa, fq


def mgref_binary() -> str:
    """The native mg-ref multi-call binary, built if missing."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    exe = os.path.join(root, "native", "build", "mgref")
    if not os.path.exists(exe):
        subprocess.run([sys.executable, "-m",
                        "bwbble_tpu_torch.build_native"], check=True,
                       cwd=root)
    return exe


def head_reads(reads: Reads, n: int) -> Reads:
    """The first n reads."""
    n = min(n, reads.count)
    return Reads(names=reads.names[:n], seq=reads.seq[:n], rc=reads.rc[:n],
                 qual=reads.qual[:n], lengths=reads.lengths[:n])


def subset_fastq(fq: str, n: int) -> str:
    """First n records of fq, cached next to it."""
    sub = os.path.join(os.path.dirname(fq), f"reads_sub{n}.fq")
    if not os.path.exists(sub):
        with open(fq, "rb") as f, open(sub, "wb") as g:
            for _ in range(4 * n):
                g.write(f.readline())
    return sub
