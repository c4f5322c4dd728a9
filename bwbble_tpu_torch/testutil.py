"""Synthetic data generation for tests and benchmarks.

Produces wgsim-style simulated reads whose names encode the ground truth
(`@chr_lpos_rpos_strand_mpos...`, parse_read_mapping io.c:529-562), matching
the reference's built-in simulation oracle (eval_alns, align.c:655-722).
"""

from __future__ import annotations

import numpy as np

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def random_genome_fasta(path: str, lengths: dict[str, int], seed: int = 0,
                        line_len: int = 60, iupac_frac: float = 0.0) -> None:
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for name, n in lengths.items():
            seq = BASES[rng.integers(0, 4, size=n)]
            if iupac_frac > 0:
                k = int(n * iupac_frac)
                pos = rng.choice(n, size=k, replace=False)
                snp_codes = np.frombuffer(b"RYSWKM", dtype=np.uint8)
                seq = seq.copy()
                seq[pos] = snp_codes[rng.integers(0, 6, size=k)]
            f.write(f">{name}\n")
            s = seq.tobytes().decode("ascii")
            for i in range(0, n, line_len):
                f.write(s[i:i + line_len] + "\n")


def random_genome_with_repeats_fasta(path: str, name: str, n: int,
                                     seed: int = 0, repeat_frac: float = 0.15,
                                     block: int = 500,
                                     mut_rate: float = 0.05,
                                     chains: bool = False,
                                     line_len: int = 60) -> None:
    """Genome with repeat structure: built block-by-block; with probability
    `repeat_frac` a block is a copy of an earlier FRESH block with
    `mut_rate` point mutations (diverged repeats — the structure that
    widens SA intervals and deepens the search on real genomes).

    chains=True additionally allows copies OF copies (preferential
    attachment): family sizes then follow a rich-get-richer law and the
    largest families reach hundreds of near-identical members, the
    pathological Alu-like regime where per-read search work explodes
    (bench.py --hard uses this)."""
    rng = np.random.default_rng(seed)
    nblocks = -(-n // block)
    blocks: list[np.ndarray] = []
    fresh: list[int] = []
    for i in range(nblocks):
        if fresh and rng.random() < repeat_frac:
            pool = blocks if chains else [blocks[j] for j in fresh]
            src = pool[int(rng.integers(0, len(pool)))].copy()
            k = rng.random(block) < mut_rate
            src[k] = BASES[rng.integers(0, 4, size=int(k.sum()))]
            blocks.append(src)
        else:
            fresh.append(i)
            blocks.append(BASES[rng.integers(0, 4, size=block)])
    seq = np.concatenate(blocks)[:n]
    with open(path, "w") as f:
        f.write(f">{name}\n")
        s = seq.tobytes().decode("ascii")
        for i in range(0, n, line_len):
            f.write(s[i:i + line_len] + "\n")


def synthetic_vcf(fasta_path: str, vcf_path: str, snp_rate: float = 0.01,
                  indel_rate: float = 0.001, seed: int = 0) -> None:
    """1000G-style VCF over a FASTA: VT=SNP records at `snp_rate` per bp and
    VT=INDEL (1-4 bp insertions/deletions) at `indel_rate` per bp, with
    genotype columns so data_prep's occurrence counting has input
    (data_prep.cpp:99-102)."""
    rng = np.random.default_rng(seed)
    seqs: dict[str, str] = {}
    nm, chunks = None, []
    with open(fasta_path) as f:
        for line in f:
            line = line.rstrip("\n")
            if line.startswith(">"):
                if nm is not None:
                    seqs[nm] = "".join(chunks)
                nm, chunks = line[1:].split()[0], []
            else:
                chunks.append(line.upper())
    if nm is not None:
        seqs[nm] = "".join(chunks)

    bases = "ACGT"
    with open(vcf_path, "w") as f:
        f.write("##fileformat=VCFv4.1\n")
        f.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT"
                "\tS1\tS2\tS3\n")
        for chrom, seq in seqs.items():
            n = len(seq)
            nsnp = int(n * snp_rate)
            nind = int(n * indel_rate)
            pos_all = np.sort(rng.choice(
                np.arange(10, n - 10), size=min(nsnp + nind, n - 20),
                replace=False))
            kinds = np.zeros(pos_all.size, dtype=np.int64)
            kinds[rng.choice(pos_all.size, size=min(nind, pos_all.size),
                             replace=False)] = 1
            for k, (pos0, kind) in enumerate(zip(pos_all, kinds)):
                pos = int(pos0) + 1              # VCF is 1-based
                ref = seq[pos - 1]
                if ref not in bases:
                    continue
                gts = ["0|0", "1|0", "0|1", "1|1"]
                gt = "\t".join(gts[int(g)] for g in rng.integers(0, 4, 3))
                if kind == 0:
                    alts = [b for b in bases if b != ref]
                    alt = alts[int(rng.integers(0, 3))]
                    f.write(f"{chrom}\t{pos}\trs{k}\t{ref}\t{alt}\t100\t"
                            f"PASS\tVT=SNP;AF=0.1\tGT\t{gt}\n")
                elif rng.integers(0, 2) == 0:    # insertion
                    ins = ref + "".join(bases[i] for i in
                                        rng.integers(0, 4,
                                                     int(rng.integers(1, 5))))
                    f.write(f"{chrom}\t{pos}\trs{k}\t{ref}\t{ins}\t100\t"
                            f"PASS\tVT=INDEL;AF=0.1\tGT\t{gt}\n")
                else:                            # deletion
                    dl = int(rng.integers(2, 6))
                    refs = seq[pos - 1: pos - 1 + dl]
                    if len(refs) < dl or any(c not in bases for c in refs):
                        continue
                    f.write(f"{chrom}\t{pos}\trs{k}\t{refs}\t{refs[0]}\t100\t"
                            f"PASS\tVT=INDEL;AF=0.1\tGT\t{gt}\n")


_COMPL = {65: "T", 67: "G", 71: "C", 84: "A"}


def simulate_reads_fastq(fasta_path: str, fastq_path: str, num_reads: int,
                         read_len: int = 100, num_mm: int = 2, seed: int = 1,
                         mm_poisson: float | None = None, mm_cap: int = 4,
                         indel_frac: float = 0.0, max_indel: int = 3
                         ) -> None:
    """Sample reads from a FASTA with random substitutions; half the reads
    are reverse-complemented.  Truth is encoded in the read name.

    `num_mm` substitutions per read, or, when `mm_poisson` is set, a
    Poisson(mm_poisson) draw capped at `mm_cap` (mixed difficulty).  With
    probability `indel_frac` a read additionally carries one 1..max_indel bp
    insertion or deletion relative to the reference (away from the read
    ends, mirroring the aligner's no-indel end zone)."""
    rng = np.random.default_rng(seed)
    # parse fasta
    seqs: list[tuple[str, str]] = []
    name, chunks = None, []
    with open(fasta_path) as f:
        for line in f:
            line = line.rstrip("\n")
            if line.startswith(">"):
                if name is not None:
                    seqs.append((name, "".join(chunks)))
                name, chunks = line[1:].split()[0], []
            else:
                chunks.append(line.upper())
    if name is not None:
        seqs.append((name, "".join(chunks)))

    with open(fastq_path, "w") as f:
        for r in range(num_reads):
            chrom, seq = seqs[rng.integers(0, len(seqs))]
            span = read_len + max_indel
            start = int(rng.integers(0, len(seq) - span + 1))
            frag = list(seq[start:start + read_len])
            if indel_frac > 0 and rng.random() < indel_frac:
                ilen = int(rng.integers(1, max_indel + 1))
                p = int(rng.integers(8, read_len - 8 - ilen))
                if rng.integers(0, 2) == 0:   # insertion into the read
                    ins = [ "ACGT"[i] for i in rng.integers(0, 4, ilen)]
                    frag = frag[:p] + ins + frag[p:]
                    frag = frag[:read_len]
                else:                          # deletion from the reference
                    tail = list(seq[start + read_len:start + read_len + ilen])
                    frag = frag[:p] + frag[p + ilen:] + tail
            nmm = (num_mm if mm_poisson is None
                   else min(int(rng.poisson(mm_poisson)), mm_cap))
            for _ in range(nmm):
                p = int(rng.integers(0, read_len))
                frag[p] = "ACGT"[(("ACGT".find(frag[p]) if frag[p] in "ACGT"
                                   else 0) + int(rng.integers(1, 4))) % 4]
            strand = int(rng.integers(0, 2))
            read = "".join(frag)
            if strand:
                read = "".join(_COMPL.get(ord(ch), "N") for ch in reversed(read))
            lpos = start + 1
            rpos = start + read_len
            sname = f"{chrom}_{lpos}_{rpos}_{'c' if strand else 'nm'}_{lpos}_{r}"
            f.write(f"@{sname}\n{read}\n+\n{'2' * read_len}\n")
