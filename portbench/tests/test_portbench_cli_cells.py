"""The quick start's cell (`chr21_mg_cli.wgsim`) and the low-error cell
(`chr21_mg.lowerr`): the readers of the deep tier and of the streamed
tier's collects against spans made by hand, what each cell reports, the
world and the donor they share with `chr21_mg.wgsim`, a whole run of the
quick start's settings on a tiny multi-genome on the CPU, and the control
at `-n` one lower (`control_budget.py`), which the low-error traffic
cannot pass."""

import json
import os

import pytest

from portbench import cell as cell_mod
from portbench import world as world_mod
from portbench.cell import metric_reader
from portbench.gen import donor as gen_donor
from portbench.record import Call, Run
from portbench.tests.helpers import REPO, TINY_MG, add_to_metric, \
    make_checkout, run_cpu

MS = 1_000_000          # ns
NEW = ("deep_tier_ms_per_kread.card", "collect_wait_ms_per_kread.card")


def _span(name, start, end, parent, **kw):
    return dict(name=name, start_ns=start * MS, end_ns=end * MS,
                parent=parent, **kw)


def _run(*spans_of_calls):
    return Run(cell="c", config={}, traffic={}, window_s=1.0, calls=[
        Call(reads=1000, stats={"spans": s}, ok=True)
        for s in spans_of_calls])


# a streamed call of 1 000 reads, in ms: the streamed first tier 10-60 with
# two collects (5 and 7 ms), a deep rung 60-80 with a collect of 9 ms, a
# second deep rung 80-84
STREAMED = [
    _span("align", 0, 100, None),
    _span("tier", 10, 60, 0, rung=0, lanes=2048, reads=1000, streamed=1),
    _span("search.dispatch", 11, 12, 1),
    _span("dbounds", 12, 20, 1),
    _span("search.collect", 20, 25, 1),
    _span("search.dispatch", 25, 26, 1),
    _span("search.collect", 30, 37, 1),
    _span("tier", 60, 80, 0, rung=1, lanes=256, reads=40, streamed=0),
    _span("search.dispatch", 60, 61, 7),
    _span("search.collect", 61, 70, 7),
    _span("tier", 80, 84, 0, rung=2, lanes=64, reads=3, streamed=0),
]
# a queued call of 1 000 reads: a first rung 0-30 (a collect of 6 ms) and a
# deep rung 30-42, none streamed
QUEUED = [
    _span("align", 0, 50, None),
    _span("tier", 0, 30, 0, rung=0, lanes=512, reads=1000, streamed=0),
    _span("search.collect", 10, 16, 1),
    _span("tier", 30, 42, 0, rung=1, lanes=128, reads=20, streamed=0),
]
# a call whose tiers say nothing of their rung (a program before the
# attributes)
BARE = [_span("align", 0, 50, None), _span("tier", 0, 30, 0),
        _span("search.collect", 10, 16, 1)]


@pytest.mark.parametrize("name, calls, want", [
    # the deep rungs alone: (20 + 4) + 12 ms over 2 000 reads
    ("deep_tier_ms_per_kread", (STREAMED, QUEUED), 36 / 2),
    ("deep_tier_ms_per_kread.card", (STREAMED, QUEUED), 36 / 2),
    # no deep rung ran: 0, not nothing
    ("deep_tier_ms_per_kread.card", (QUEUED[:3],), 0.0),
    # the streamed tier's collects alone: 5 + 7 ms over 2 000 reads (the
    # deep rung's and the queued call's collects do not count)
    ("collect_wait_ms_per_kread", (STREAMED, QUEUED), 12 / 2),
    ("collect_wait_ms_per_kread.card", (STREAMED, QUEUED), 12 / 2),
])
def test_reader_value_by_hand(name, calls, want):
    assert metric_reader(name).read(_run(*calls)) == pytest.approx(
        want, rel=1e-12)


@pytest.mark.parametrize("name", [
    "deep_tier_ms_per_kread", "deep_tier_ms_per_kread.card",
    "collect_wait_ms_per_kread", "collect_wait_ms_per_kread.card"])
def test_reader_reads_nothing_without_its_spans(name):
    reader = metric_reader(name)
    assert reader.read(_run(BARE)) is None
    assert reader.read(Run(cell="c", config={}, traffic={}, window_s=1.0,
                           calls=[Call(reads=10, stats={}, ok=True)])) \
        is None
    if name.startswith("collect_wait"):
        # no call streamed: the cell has left the branch
        assert reader.read(_run(QUEUED)) is None


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("workload", ["chr21_mg.lowerr",
                                      "chr21_mg_cli.wgsim"])
def test_cell_reports(bench, workload):
    cell = cell_mod.load(workload)
    assert cell.chips == 1
    assert {m["name"] for m in cell.end_to_end} == {"card_ms_per_kread",
                                                    "setup_s"}
    per_layer = {m["name"] for m in cell.per_layer}
    # the accepted per-layer metrics without a list of cells, and the new
    # ones where they list the cell
    unlisted = {m["name"] for m in bench["per_layer"]
                if "workloads" not in m
                and m["moves"] == "card_ms_per_kread"}
    assert unlisted and unlisted <= per_layer
    assert "deep_tier_ms_per_kread.card" in per_layer
    assert ("collect_wait_ms_per_kread.card" in per_layer) == (
        workload == "chr21_mg_cli.wgsim")
    for m in cell.per_layer:
        assert cell_mod.metric_reader(m["name"]).MOVES == m["moves"]


def test_shared_world_and_donor():
    mg = cell_mod.load("chr21_mg.wgsim")
    cli = cell_mod.load("chr21_mg_cli.wgsim")
    low = cell_mod.load("chr21_mg.lowerr")
    # one cached world, `.bwt`, VCF and donor for the three cells
    assert world_mod.key_of(cli.config["world"]) == world_mod.key_of(
        mg.config["world"])
    assert gen_donor.key_of(low.traffic["donor"]) == gen_donor.key_of(
        mg.traffic["donor"])
    assert low.config is not mg.config and low.config == mg.config
    # the traffic differs in its error rate alone, of what draws reads
    differ = {k for k in set(mg.traffic) | set(low.traffic)
              if mg.traffic.get(k) != low.traffic.get(k)}
    assert differ == {"name", "source", "why", "error_rate", "assumed"}
    assert low.traffic["error_rate"] == 0.001


def test_quick_start_settings(bench):
    """The CLI's settings, written out: fixed batches of 2 048, the
    default arena and engine, d_cap 32, no --queued."""
    from bwbble_tpu_torch.align.params import AlnParams
    from bwbble_tpu_torch.engine.inexact import EngineConfig
    a = cell_mod.load("chr21_mg_cli.wgsim").config["align"]
    defaults = AlnParams()
    assert a["params"] == dict(max_diff=4, is_multiref=True, n_threads=8,
                               batch_size=defaults.batch_size)
    e = EngineConfig()
    assert a["engine"] == dict(cap=defaults.arena_cap, acap=e.acap,
                               kx=e.kx, max_iters=e.max_iters)
    assert a["index"] == {} and a["call"] == {"d_cap": 32, "queued": False}
    entry = next(c for c in bench["configs"] if c["name"] == "chr21_mg_cli")
    assert entry["reduced"] == []


def test_quick_start_run_on_the_cpu(tmp_path):
    """A whole traced run of the quick start's settings, batches scaled to
    a tiny multi-genome: the call streams, and the new readers read.  The
    tiny world's reads overflow a D cap of 32 too rarely for the probe to
    skip the device D pass, as it does on chr21 at 32: a cap of 3 does."""
    ck = make_checkout(str(tmp_path))
    cfg = dict(TINY_MG, name="tiny_mg_cli")
    cfg["align"] = dict(TINY_MG["align"], engine={
        "cap": 32768, "acap": 24, "kx": 4, "max_iters": 200000},
        call={"d_cap": 3, "queued": False})
    with open(os.path.join(ck, "portbench", "configs",
                           "tiny_mg_cli.json"), "w") as f:
        json.dump(cfg, f)
    bench_path = os.path.join(ck, "BENCHMARK.json")
    with open(bench_path) as f:
        bench = json.load(f)
    bench["workloads"].append({"name": "tiny_mg_cli.wgsim",
                               "config": "tiny_mg_cli", "traffic": "wgsim",
                               "chips": 1, "why": "test"})
    add_to_metric(bench, "reads_per_s", ["tiny_mg_cli.wgsim"])
    for m in bench["per_layer"]:
        if m["name"] in NEW:
            m["workloads"].append("tiny_mg_cli.wgsim")
    with open(bench_path, "w") as f:
        json.dump(bench, f)
    _, res, forbidden = run_cpu(ck, "tiny_mg_cli.wgsim", seed=2**31 + 17,
                                trace=True)
    assert res["correct"] is True and forbidden == []
    assert set(NEW) <= set(res["metrics"])
    assert res["metrics"]["collect_wait_ms_per_kread.card"]["value"] >= 0


@pytest.fixture(scope="module")
def lowerr_checkout(tmp_path_factory):
    """A checkout with the tiny cells and `tiny_mg.lowerr`, the low-error
    traffic on the tiny multi-genome."""
    ck = make_checkout(str(tmp_path_factory.mktemp("lowerr")))
    bench_path = os.path.join(ck, "BENCHMARK.json")
    with open(bench_path) as f:
        bench = json.load(f)
    bench["workloads"].append({"name": "tiny_mg.lowerr", "config": "tiny_mg",
                               "traffic": "lowerr", "chips": 1,
                               "why": "test"})
    add_to_metric(bench, "reads_per_s", ["tiny_mg.lowerr"])
    with open(bench_path, "w") as f:
        json.dump(bench, f)
    return ck


# (cell, budget): one lower than the configuration's `-n 4` where the
# traffic's reads reach it, `-n 1` on the low-error reads, which seldom
# carry more than one difference
@pytest.mark.parametrize("workload, max_diff", [
    ("tiny_mg.lowerr", 1), ("tiny_mg.wgsim", None),
    ("tiny_single.wgsim", None)])
@pytest.mark.parametrize("seed", [2**31 + 23, 2**40 + 29])
def test_budget_control_fails_the_comparison(lowerr_checkout, workload,
                                             max_diff, seed, monkeypatch):
    from portbench.control_budget import control_reading
    monkeypatch.chdir(lowerr_checkout)
    r = control_reading(workload, seed, n_calls=8,
                        root=os.path.join(lowerr_checkout, "portbench"),
                        workers=2, max_diff=max_diff)
    assert r["checked_reads"] > 0 and r["max_diff"] == (max_diff or 3)
    assert r["control_wrong_reads"] > 0 and r["correct"] is False
    assert r["checks"]["wrong_reads"]["value"] == r["control_wrong_reads"]


# the program searched with the whole budget `-n 1`, in every call
NARROWED = """
import dataclasses
import bwbble_tpu_torch.engine.pipeline as P
_orig = P.align_reads_device
def narrowed(idx, didx, reads, params, *a, **k):
    return _orig(idx, didx, reads, dataclasses.replace(params, max_diff=1),
                 *a, **k)
P.align_reads_device = narrowed
"""


def test_program_at_a_narrower_budget_is_not_correct(lowerr_checkout):
    """Through the run's own comparison: on low-error reads, a program
    that searches with `-n 1` in place of the configuration's `-n 4` is
    caught."""
    _, res, _ = run_cpu(lowerr_checkout, "tiny_mg.lowerr", seed=2**31 + 31,
                        seconds=2.0, patch=NARROWED)
    assert res["correct"] is False
    assert res["checks"]["wrong_reads"]["value"] > 0
    assert res["checks"]["unanswered_reads"]["value"] == 0
