"""Simulated reads as FASTQ bytes, drawn from a seed by a traffic file.

Single-end reads as wgsim (H. Li, github.com/lh3/wgsim) draws them, from
the donor's haplotypes (`gen/donor.py`): a haplotype at even odds, a
uniform start on it, `read_len` bases; each base a sequencing error with
probability `error_rate`, moved to one of the three others (wgsim's
errors are substitutions); with probability `reverse_share` the read is
reverse complemented.

Every record has the same length (the name is fixed-width), so a pool of
reads is one array and a call's reads are one slice of it.
"""

from __future__ import annotations

import numpy as np

ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)
_INDEX = np.full(256, 0, dtype=np.int64)
_INDEX[ACGT] = np.arange(4)
_COMPL = np.arange(256, dtype=np.uint8)
_COMPL[ACGT] = np.frombuffer(b"TGCA", dtype=np.uint8)
NAME_LEN = 22           # start (10 digits) _ strand _ serial (9 digits)
CHUNK = 1 << 16         # reads drawn at a time (bounds the index arrays)


def rng_of(seed: int, stream: int) -> np.random.Generator:
    """The generator of one stream of a run's draws, from `--seed`."""
    return np.random.default_rng(
        np.random.SeedSequence([int(seed) % (1 << 64), stream]))


def record_len(read_len: int) -> int:
    return 1 + NAME_LEN + 1 + read_len + 3 + read_len + 1


def simulate(flat: np.ndarray, lens: np.ndarray, n: int, traffic: dict,
             rng: np.random.Generator) -> dict:
    """`n` reads from the donor's haplotypes, which lie one after another
    in `flat` (uint8 ASCII, ACGT only) with lengths `lens`: the bases
    (uint8 [n, read_len]) and the truth of each read: haplotype, start on
    it, strand (1 = reverse complemented), and sequencing errors."""
    L = int(traffic["read_len"])
    offs = np.cumsum(lens) - lens
    hap = rng.integers(0, lens.shape[0], size=n)
    start = (rng.random(n) * (lens[hap] - L + 1)).astype(np.int64)
    seq = flat[(offs[hap] + start)[:, None] + np.arange(L)[None, :]]
    err = rng.random((n, L)) < float(traffic["error_rate"])
    shift = rng.integers(1, 4, size=(n, L))
    seq = np.where(err, ACGT[(_INDEX[seq] + shift) % 4], seq)
    strand = rng.random(n) < float(traffic["reverse_share"])
    seq[strand] = _COMPL[seq[strand][:, ::-1]]
    return dict(seq=seq.astype(np.uint8), hap=hap, start=start,
                strand=strand, n_err=err.sum(axis=1))


def _digits(x: np.ndarray, width: int) -> np.ndarray:
    pw = 10 ** np.arange(width - 1, -1, -1, dtype=np.int64)
    return ((x[:, None] // pw[None, :]) % 10 + 48).astype(np.uint8)


def fastq_records(sim: dict, serial0: int) -> np.ndarray:
    """uint8 [n, record_len]: one FASTQ record a row, quality '2'."""
    seq = sim["seq"]
    n, L = seq.shape
    out = np.empty((n, record_len(L)), dtype=np.uint8)
    out[:, 0] = ord("@")
    out[:, 1:11] = _digits(sim["start"] + 1, 10)
    out[:, 11] = ord("_")
    out[:, 12] = np.where(sim["strand"], ord("c"), ord("f"))
    out[:, 13] = ord("_")
    out[:, 14:23] = _digits(np.arange(serial0, serial0 + n), 9)
    out[:, 23] = ord("\n")
    out[:, 24:24 + L] = seq
    out[:, 24 + L:27 + L] = np.frombuffer(b"\n+\n", dtype=np.uint8)
    out[:, 27 + L:27 + 2 * L] = ord("2")
    out[:, 27 + 2 * L] = ord("\n")
    return out


def make_pool(haps: list, traffic: dict, seed: int, n_calls: int,
              reads_per_call: int, threads: int = 8) -> np.ndarray:
    """uint8 [n_calls, reads_per_call, record_len]: the FASTQ records of
    every call of a run, drawn from `seed`.  Chunk c of CHUNK reads draws
    from stream c + 1 of the seed, so the pool does not depend on the
    number of threads that fill it."""
    from concurrent.futures import ThreadPoolExecutor
    L = int(traffic["read_len"])
    total = n_calls * reads_per_call
    out = np.empty((total, record_len(L)), dtype=np.uint8)
    flat = np.concatenate(haps)
    lens = np.array([h.shape[0] for h in haps], dtype=np.int64)

    def fill(s: int) -> None:
        e = min(s + CHUNK, total)
        sim = simulate(flat, lens, e - s, traffic,
                       rng_of(seed, 1 + s // CHUNK))
        out[s:e] = fastq_records(sim, s)

    with ThreadPoolExecutor(max(1, threads)) as ex:
        for f in [ex.submit(fill, s) for s in range(0, total, CHUNK)]:
            f.result()
    return out.reshape(n_calls, reads_per_call, -1)
