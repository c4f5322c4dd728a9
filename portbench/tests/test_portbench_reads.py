"""The read simulator and the donor follow their traffic file: the errors'
histogram, the strand and haplotype shares, the donor's VCF alleles and
wgsim's mutation rates; and a seed always draws the same reads."""

import dataclasses
import json
import math
import os

import numpy as np
import pytest

from portbench.gen import donor, genome as gen_genome, reads
from portbench.reference.align import codes_of

TRAFFIC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "traffic")
N = 20000


@pytest.fixture(scope="module")
def wgsim():
    with open(os.path.join(TRAFFIC, "wgsim.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def haps():
    rng = np.random.default_rng(0)
    return [reads.ACGT[rng.integers(0, 4, size=n)]
            for n in (400_000, 399_990)]


def _within(count, n, p):
    sd = math.sqrt(n * p * (1 - p))
    return abs(count - n * p) <= 4 * sd + 1


def _simulate(haps, n, traffic, rng):
    lens = np.array([h.shape[0] for h in haps])
    return reads.simulate(np.concatenate(haps), lens, n, traffic, rng)


def test_reads_follow_the_traffic_file(haps, wgsim):
    sim = _simulate(haps, N, wgsim, reads.rng_of(2**31 + 3, 0))
    L, e = wgsim["read_len"], wgsim["error_rate"]
    fwd = sim["seq"].copy()
    s = sim["strand"]
    fwd[s] = reads._COMPL[fwd[s][:, ::-1]]
    src = np.stack([haps[h][a:a + L]
                    for h, a in zip(sim["hap"], sim["start"])])
    diffs = (fwd != src).sum(axis=1)
    # a read differs from its haplotype at its sequencing errors alone
    assert np.array_equal(diffs, sim["n_err"])
    for k in range(6):
        p = math.comb(L, k) * e ** k * (1 - e) ** (L - k)
        assert _within(int((diffs == k).sum()), N, p), k
    assert _within(int(s.sum()), N, wgsim["reverse_share"])
    assert _within(int((sim["hap"] == 1).sum()), N, 0.5)
    assert (sim["start"] + L <= np.array([len(h) for h in haps])[
        sim["hap"]]).all()


def test_apply_events_by_hand():
    g = np.frombuffer(b"AAAACCCCGGGGTTTT", dtype=np.uint8)
    # a SNP, an insertion after base 5, a deletion of bases 9-10, and an
    # event that starts inside the deletion (dropped)
    out = donor.apply_events(g, [2, 5, 8, 9], [1, 1, 3, 1],
                             [b"G", b"CTT", b"G", b"A"])
    assert out.tobytes() == b"AAGA" + b"C" + b"CTT" + b"CC" + b"G" + b"G" \
        + b"TTTT"


@dataclasses.dataclass
class _World:
    path: str
    genome_fa: str
    vcf: str | None


def _world(tmp_path, n, snp_rate, indel_rate):
    fa = str(tmp_path / "genome.fa")
    gen_genome.random_genome_with_repeats_fasta(fa, "21", n, seed=5,
                                                repeat_frac=0.0)
    vcf = str(tmp_path / "variants.vcf")
    gen_genome.synthetic_vcf(fa, vcf, snp_rate=snp_rate,
                             indel_rate=indel_rate, seed=6)
    return _World(str(tmp_path), fa, vcf)


def test_donor_carries_its_vcf_sample(tmp_path, wgsim):
    w = _world(tmp_path, 50_000, 0.02, 0.0)
    d = dict(wgsim["donor"], mut_rate=0.0)
    h = donor.haplotypes(w, d)
    g = gen_genome.read_genome(w.genome_fa)
    assert [x.shape[0] for x in h] == [g.shape[0]] * 2
    n_alt = 0
    with open(w.vcf) as f:
        for line in f:
            if line.startswith("#"):
                continue
            c = line.split("\t")
            gt = c[9 + ["S1", "S2", "S3"].index(d["vcf_sample"])].strip()
            p = int(c[1]) - 1
            for side in range(2):
                want = c[4] if gt.split("|")[side] == "1" else c[3]
                assert chr(h[side][p]) == want
                n_alt += want == c[4]
    assert n_alt > 0
    # cached: the second call reads the file the first wrote
    assert [x.tobytes() for x in donor.haplotypes(w, d)] == \
        [x.tobytes() for x in h]


def test_donor_has_wgsims_mutations(wgsim):
    n = 2_000_000
    g = reads.ACGT[np.random.default_rng(1).integers(0, 4, size=n)]
    d = wgsim["donor"]
    ev = donor._wgsim_events(g, d)
    pos = np.concatenate([np.asarray(ev[h][0]) for h in range(2)])
    sites = np.unique(pos)
    assert _within(sites.size, n, d["mut_rate"])
    both = np.intersect1d(ev[0][0], ev[1][0]).size
    assert _within(both, sites.size, 1 / 3)
    indels = {p for h in range(2) for p, r, a in zip(*ev[h])
              if r != 1 or len(a) != 1}
    assert _within(len(indels), sites.size, d["indel_frac"])
    lens = [len(a) - 1 for h in range(2) for r, a in zip(*ev[h][1:])
            if len(a) > 1]
    assert max(lens) <= donor.MAX_INS and min(lens) >= 1


def test_a_seed_draws_the_same_pool(haps, wgsim):
    a = reads.make_pool(haps, wgsim, 2**33 + 1, 3, 1000, threads=1)
    b = reads.make_pool(haps, wgsim, 2**33 + 1, 3, 1000, threads=4)
    c = reads.make_pool(haps, wgsim, 2**33 + 2, 3, 1000, threads=4)
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    assert len({a[k].tobytes() for k in range(3)}) == 3


def test_records_are_fastq(haps, wgsim):
    pool = reads.make_pool(haps, wgsim, 1, 1, 8)
    rec = pool[0, 0].tobytes()
    lines = rec.split(b"\n")
    assert lines[0].startswith(b"@") and lines[2] == b"+"
    assert len(lines[1]) == len(lines[3]) == wgsim["read_len"]
    seq, rc = codes_of(rec)
    assert seq.shape == rc.shape == (wgsim["read_len"],)
    assert (seq < 4).all()
