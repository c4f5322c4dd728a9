"""Whole runs of the harness on the CPU at tiny sizes: the result line,
the checks, and faults of the timed path that `correct` has to catch."""

import pytest

from portbench.tests.helpers import run_cpu

END_TO_END = {"reads_per_s", "setup_s"}
PER_LAYER_CPU = {"io_ms_per_kread", "dbound_ms_per_kread",
                 "gold_routed_pct", "search_ms_per_kread",
                 "host_ms_per_kread"}


@pytest.mark.parametrize("workload", ["tiny_mg.wgsim", "tiny_single.wgsim"])
def test_run_prints_the_contract_line(checkout, workload):
    info, res, forbidden = run_cpu(checkout, workload, seed=2**31 + 11)
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] == info["reads"] > 0
    assert set(res["metrics"]) == END_TO_END
    assert res["metrics"]["reads_per_s"]["unit"] == "reads/s"
    assert res["device"]["count"] == 1
    assert res["checks"] == {"wrong_reads": {"value": 0, "limit": 0},
                             "unanswered_reads": {"value": 0, "limit": 0}}
    assert info["checked_reads"] == info["reads"]
    assert forbidden == []


def test_traced_run_reports_the_layers(checkout):
    _, res, forbidden = run_cpu(checkout, "tiny_mg.wgsim", seed=5,
                                trace=True)
    assert res["correct"] is True
    # no card: the device's readers find nothing, and say nothing
    assert set(res["metrics"]) == PER_LAYER_CPU
    assert res["metrics"]["gold_routed_pct"]["unit"] == "%"
    assert forbidden == []


def test_same_seed_same_reads(checkout):
    a, _, _ = run_cpu(checkout, "tiny_single.wgsim", seed=3)
    b, _, _ = run_cpu(checkout, "tiny_single.wgsim", seed=3)
    assert a["reads"] == b["reads"]


BREAK = """
import bwbble_tpu_torch.engine.pipeline as P
_orig = P.align_reads_device
_calls = [0]
def broken(idx, didx, reads, *a, **k):
    out = _orig(idx, didx, reads, *a, **k)
    _calls[0] += 1
    if _calls[0] > 1:               # the warm-up call stays sound
        FAULT
    return out
P.align_reads_device = broken
"""
FAULTS = {
    # half of each call's reads left out: their records come back empty
    "half_left_out": "out[::2] = [[] for _ in out[::2]]",
    # one answer altered where it is produced: a record's interval moves
    "answer_altered": "next(r for r in out if r)[0].L += 1",
    # a call that raises: its reads are never answered
    "call_raises": "raise RuntimeError('a planted fault')",
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_timed_path_is_not_correct(checkout, fault):
    _, res, _ = run_cpu(checkout, "tiny_mg.wgsim", seed=9,
                        patch=BREAK.replace("FAULT", FAULTS[fault]))
    assert res["correct"] is False
    if fault == "call_raises":
        assert res["checks"]["unanswered_reads"]["value"] == res["failed"]
        assert res["failed"] == res["attempted"] > 0
    else:
        assert res["checks"]["wrong_reads"]["value"] > 0
