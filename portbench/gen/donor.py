"""The donor of a run's reads: the individual whose genome is sequenced,
made as wgsim (H. Li, github.com/lh3/wgsim, `wgsim_mut_diref`) makes one.

Two haplotypes of the world's genome.  Where the world has a VCF, each
haplotype first carries the ALT alleles of one side of a phased genotype
column (`vcf_sample`).  On top of those come wgsim's own mutations: one at
`mut_rate` of the bases, `indel_frac` of them indels, half insertions
(1 to 4 bases, each further base taken with `indel_extend`) and half
deletions (one base, each further base taken with `indel_extend`); a
third of them homozygous, the rest on one haplotype, even odds.  Where
two changes would overlap on one haplotype, the later one is dropped.

The donor depends on the world and the traffic's `donor` section alone,
never on the run's seed, so every seed reads the same genome.  It is
built once and cached in the world's directory.
"""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np

from portbench.gen.genome import read_genome

ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)
PLOIDY = 2
MAX_INS = 4             # wgsim's longest insertion


def _vcf_events(vcf: str, sample: str) -> list:
    """(pos 0-based, ref length, alt bytes) of the ALT alleles of each
    side of `sample`'s phased genotypes."""
    out: list = [([], [], []) for _ in range(PLOIDY)]
    col = None
    with open(vcf) as f:
        for line in f:
            if line.startswith("##"):
                continue
            cols = line.rstrip("\n").split("\t")
            if line.startswith("#"):
                col = cols.index(sample)
                continue
            gt = cols[col].split("|")
            for h in range(PLOIDY):
                if gt[h] == "1":
                    out[h][0].append(int(cols[1]) - 1)
                    out[h][1].append(len(cols[3]))
                    out[h][2].append(cols[4].encode())
    return out


def _wgsim_events(genome: np.ndarray, donor: dict) -> list:
    """wgsim's mutations of a diploid donor, per haplotype, as
    (pos, ref length, alt bytes) lists."""
    rng = np.random.default_rng(int(donor["seed"]))
    ext = float(donor["indel_extend"])
    pos = np.flatnonzero(rng.random(genome.shape[0]) < float(
        donor["mut_rate"]))
    m = pos.size
    indel = rng.random(m) < float(donor["indel_frac"])
    insert = rng.random(m) < 0.5
    hom = rng.random(m) < 1.0 / 3.0
    side = rng.integers(0, PLOIDY, size=m)
    shift = rng.integers(1, 4, size=m)
    length = rng.geometric(1.0 - ext, size=m) if ext < 1 else np.ones(m, int)
    ins_len = np.minimum(length, MAX_INS)
    ins_bases = ACGT[rng.integers(0, 4, size=(m, MAX_INS))]
    base_idx = np.searchsorted(ACGT, genome[pos])
    out: list = [([], [], []) for _ in range(PLOIDY)]
    for k in range(m):
        p = int(pos[k])
        if not indel[k]:
            ev = (1, ACGT[(base_idx[k] + shift[k]) % 4].tobytes())
        elif insert[k]:
            ev = (1, genome[p:p + 1].tobytes()
                  + ins_bases[k, :ins_len[k]].tobytes())
        else:
            ev = (int(length[k]), b"")
        for h in range(PLOIDY):
            if hom[k] or side[k] == h:
                out[h][0].append(p)
                out[h][1].append(ev[0])
                out[h][2].append(ev[1])
    return out


def apply_events(genome: np.ndarray, pos, ref_len, alt) -> np.ndarray:
    """The genome with genome[pos:pos + ref_len] replaced by alt at each
    event, dropping an event that starts inside an earlier one."""
    pos = np.asarray(pos, dtype=np.int64)
    ref_len = np.asarray(ref_len, dtype=np.int64)
    order = np.argsort(pos, kind="stable")
    pos, ref_len = pos[order], ref_len[order]
    alt = [alt[i] for i in order]
    end = np.minimum(pos + ref_len, genome.shape[0])
    before = np.maximum.accumulate(np.concatenate([[0], end[:-1]]))
    keep = pos >= before
    pos, end = pos[keep], end[keep]
    alt = [a for a, k in zip(alt, keep) if k]
    n = genome.shape[0]
    cover = np.zeros(n + 1, dtype=np.int32)
    np.add.at(cover, pos, 1)
    np.add.at(cover, end, -1)
    covered = np.cumsum(cover[:n]) > 0
    alt_len = np.array([len(a) for a in alt], dtype=np.int64)
    counts = (~covered).astype(np.int64)
    counts[pos] = alt_len
    offs = np.cumsum(counts) - counts
    out = np.empty(int(counts.sum()), dtype=np.uint8)
    out[offs[~covered]] = genome[~covered]
    if alt_len.sum():
        flat = np.frombuffer(b"".join(alt), dtype=np.uint8)
        within = np.arange(flat.size) - np.repeat(
            np.cumsum(alt_len) - alt_len, alt_len)
        out[np.repeat(offs[pos], alt_len) + within] = flat
    return out


def key_of(donor: dict) -> str:
    return hashlib.sha256(json.dumps(donor, sort_keys=True).encode()
                          ).hexdigest()[:16]


def haplotypes(world, donor: dict) -> list:
    """The donor's haplotypes (uint8 ASCII arrays) over `world`, from the
    world's cache or built there."""
    path = os.path.join(world.path, f"donor-{key_of(donor)}.npz")
    if not os.path.exists(path):
        genome = read_genome(world.genome_fa)
        ev = _wgsim_events(genome, donor)
        if world.vcf is not None:
            vcf = _vcf_events(world.vcf, donor["vcf_sample"])
            ev = [tuple(a + b for a, b in zip(vcf[h], ev[h]))
                  for h in range(PLOIDY)]
        haps = [apply_events(genome, *ev[h]) for h in range(PLOIDY)]
        tmp = path + ".building"
        with open(tmp, "wb") as f:
            np.savez(f, *haps)
        os.replace(tmp, path)
    with np.load(path) as z:
        return [z[f"arr_{h}"] for h in range(PLOIDY)]
