"""The search kernel's byte count against a case worked by hand."""

import os

from portbench.metrics import search_roofline
from portbench.record import Call, Run
from portbench.reference.aln import encode_alns
from portbench.reference.gold import Aln
from portbench.rooflines import search


def test_read_bytes_by_hand():
    # 100 codes (int8) + a length (int32) + 101 D pairs + 33 seed pairs
    assert search.read_bytes(100, 32) == 100 + 4 + 101 * 8 + 33 * 8 == 1176


def test_record_bytes_by_hand():
    # a count, then per record six words and 2 bits a state
    assert search.record_bytes([]) == 4
    assert search.record_bytes([100, 7]) == 4 + (24 + 25) + (24 + 2) == 79


def _aln(n):
    return Aln(score=3, L=5, U=5, num_mm=1, num_gapo=0, num_gape=0,
               num_snps=0, aln_length=n, path=bytes(n))


def test_share_counts_the_reads_the_device_finished(tmp_path):
    path = os.path.join(tmp_path, "c.aln")
    # three reads: one record of 100, none, two records of 100 and 100
    with open(path, "wb") as f:
        for alns in ([_aln(100)], [], [_aln(100), _aln(100)]):
            f.write(encode_alns(alns))
    call = Call(reads=3, stats={"t_search": 1e-6, "fallback_reads": 1},
                aln_path=path, ok=True)
    run = Run(cell="c", config={}, traffic={"read_len": 100},
              calls=[call], window_s=1.0)
    # two reads finished on the device: the two smallest records (4 and
    # 4 + 49) and two reads' inputs
    least = 2 * 1176 + 4 + 53
    want = 100.0 * least / 3.35e12 / 1e-6
    assert abs(search_roofline.read(run) - want) < 1e-12
    # no card, or no search time: nothing to read
    run.device = "cpu"
    assert search_roofline.read(run) is None
