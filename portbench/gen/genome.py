"""Genomes and variant files of the benchmark's worlds.

Frozen copies of `random_genome_with_repeats_fasta` and `synthetic_vcf` (bwbble_tpu_torch/testutil.py): the same seed writes
the same bytes as the program's copies did when the benchmark was made.
"""

from __future__ import annotations

import numpy as np

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


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


def read_genome(fasta_path: str) -> np.ndarray:
    """The ASCII bases of a one-sequence FASTA file, uppercased, as uint8."""
    with open(fasta_path, "rb") as f:
        data = f.read()
    body = data[data.index(b"\n") + 1:].translate(None, delete=b"\n")
    return np.frombuffer(body.upper(), dtype=np.uint8)
