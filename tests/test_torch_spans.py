"""The spans `align_reads_device` records into `stats["spans"]`
(engine/spans.py), on the CPU at tiny sizes: the queued multi-genome branch
with the whole threaded scan (the probe's skip) and with a device pass plus
the serial escalation, the fixed single-genome (`-S`) branch and the
streamed scan-and-launch branch, each of the three also with a deep rung.
Each call's spans nest, lie on the `time.time_ns()` clock around the call,
count one scan span a thread a chunk and one dispatch and one collect a
launch, give `t_dbounds`, and say of each tier its rung, lanes, reads and
whether it streamed; without `stats` nothing is recorded and the `.aln`
bytes are the same.  At the quick start's settings (`align -n 4`: fixed
batches, the default arena and D cap) a multi-genome whose IUPAC codes
overflow the D cap on nearly every read takes the streamed branch, and
its records are the gold engine's."""

import collections
import time

import pytest
import torch

from bwbble_tpu_torch import native as t_native
from bwbble_tpu_torch.align.params import AlnParams
from bwbble_tpu_torch.align.pipeline import align_reads_gold
from bwbble_tpu_torch.engine import pipeline
from bwbble_tpu_torch.engine.device_index import from_fmindex
from bwbble_tpu_torch.engine.inexact import EngineConfig
from bwbble_tpu_torch.engine.spans import Spans
from bwbble_tpu_torch.formats.aln import encode_alns
from bwbble_tpu_torch.formats.fasta import fasta2ref
from bwbble_tpu_torch.formats.fastq import read_fastq
from bwbble_tpu_torch.index import FMIndex
from bwbble_tpu_torch.testutil import random_genome_fasta, simulate_reads_fastq

from test_torch_fixed import pipe_world  # noqa: F401
from test_torch_pipeline import native_lib  # noqa: F401

torch.set_num_threads(1)

# branch: (world, native library, d_cap, queued, batch, arena cap).  On the
# multi-genome world the probe skips the device pass at d_cap 3 and, at
# d_cap 6, runs it at K = 6 and leaves reads to the serial escalation.  A
# deep rung runs where reads overflow the first pass and the rung has
# fewer lanes than it (the streamed branch's ladder runs whatever the
# first pass's lanes): 144 lanes above the queued rung's 128, 512 above
# the fixed ladder's 256, whose arena of 256 rows a read few finish in.
BRANCHES = {
    "queued_probe_skip": ("mg", True, 3, True, 128, 4096),
    "queued_escalation": ("mg", True, 6, True, 128, 4096),
    "queued_deep": ("mg", True, 3, True, 144, 4096),
    "fixed_single": ("single", False, 16, False, 128, 4096),
    "fixed_single_deep": ("single", False, 16, False, 512, 256),
    "streamed": ("mg", True, 3, False, 128, 4096),
}
DEEP = {"queued_deep", "fixed_single_deep", "streamed"}
PARAMS = {"mg": dict(max_diff=2, n_threads=2),
          "single": dict(max_diff=2, is_multiref=False)}
# the parents a span may have
PARENTS = {
    "gold.start": {"align"},
    "dbounds": {"align", "tier"},
    "dbounds.probe": {"dbounds"},
    "dbounds.device": {"dbounds"},
    "dbounds.native": {"dbounds"},
    "dbounds.scan": {"dbounds.native"},
    "route": {"align", "tier", "dbounds", "dbounds.device"},
    "tier": {"align"},
    "search.dispatch": {"tier"},
    "search.collect": {"tier"},
    "assemble": {"tier", "align"},
    "gold.drain": {"align"},
}
COMMON = {"align", "dbounds", "route", "tier", "search.dispatch",
          "search.collect", "assemble"}
EXPECTED = {
    "queued_probe_skip": COMMON | {"gold.start", "dbounds.probe",
                                   "dbounds.native", "dbounds.scan",
                                   "gold.drain"},
    "queued_escalation": COMMON | {"gold.start", "dbounds.probe",
                                   "dbounds.device", "dbounds.native",
                                   "dbounds.scan", "gold.drain"},
    "fixed_single": COMMON | {"dbounds.device"},
    "streamed": COMMON | {"gold.start", "dbounds.probe", "dbounds.native",
                          "dbounds.scan", "gold.drain"},
}
EXPECTED["queued_deep"] = EXPECTED["queued_probe_skip"]
EXPECTED["fixed_single_deep"] = EXPECTED["fixed_single"]
ABSENT = {
    "queued_probe_skip": {"dbounds.device"},
    "queued_escalation": set(),
    "fixed_single": {"gold.start", "dbounds.probe", "dbounds.native",
                     "dbounds.scan"},
    "streamed": {"dbounds.device"},
}
ABSENT["queued_deep"] = ABSENT["queued_probe_skip"]
ABSENT["fixed_single_deep"] = ABSENT["fixed_single"]
TIER_KEYS = ("rung", "lanes", "reads", "streamed")


@pytest.fixture(scope="module")
def single_world(tmp_path_factory):
    d = tmp_path_factory.mktemp("spans_single")
    fa, fq = str(d / "s.fa"), str(d / "s.fq")
    random_genome_fasta(fa, {"1": 20_000}, seed=31)
    simulate_reads_fastq(fa, fq, 150, read_len=36, mm_poisson=1.0, mm_cap=2,
                         indel_frac=0.1, max_indel=1, seed=32)
    codes, _ = fasta2ref(fa, fa + ".ref", fa + ".ann")
    return dict(idx=FMIndex.build(codes), reads=read_fastq(fq))


@pytest.fixture(scope="module")
def dense_world(tmp_path_factory):
    """A multi-genome with an IUPAC code at a tenth of its positions: at the
    default D cap of 32 the probe finds nearly every read overflowing, as
    on a chr21 multi-genome, and skips the device D pass."""
    d = tmp_path_factory.mktemp("spans_dense")
    fa, fq = str(d / "d.fa"), str(d / "d.fq")
    random_genome_fasta(fa, {"21": 24_000}, seed=21, iupac_frac=0.1)
    simulate_reads_fastq(fa, fq, 160, read_len=36, mm_poisson=1.0, mm_cap=2,
                         indel_frac=0.1, max_indel=1, seed=22)
    codes, _ = fasta2ref(fa, fa + ".ref", fa + ".ann")
    return dict(idx=FMIndex.build(codes), reads=read_fastq(fq))


@pytest.fixture
def branch_run(pipe_world, single_world, native_lib,  # noqa: F811
               monkeypatch):
    """run(branch, stats, params) -> (.aln bytes, time_ns before, time_ns
    after); `params` in place of the branch's world's."""

    def run(branch, stats, params=None):
        world, native, d_cap, queued, batch, cap = BRANCHES[branch]
        w = pipe_world if world == "mg" else single_world
        monkeypatch.setattr(t_native, "_native", native_lib if native
                            else None)
        monkeypatch.setattr(t_native, "_tried", True)
        didx = from_fmindex(w["idx"], device="cpu")
        t0 = time.time_ns()
        alns = pipeline.align_reads_device(
            w["idx"], didx, w["reads"],
            params or AlnParams(batch_size=batch, **PARAMS[world]),
            EngineConfig(cap=cap, acap=24), d_cap=d_cap, queued=queued,
            qchunk=1, stats=stats, device="cpu")
        t1 = time.time_ns()
        return b"".join(encode_alns(a) for a in alns), t0, t1
    return run


@pytest.mark.parametrize("branch", sorted(BRANCHES))
def test_spans_of_each_branch(branch_run, branch):
    stats: dict = {}
    _, t0, t1 = branch_run(branch, stats)
    spans = stats["spans"]
    names = collections.Counter(s["name"] for s in spans)
    assert EXPECTED[branch] <= set(names) <= set(PARENTS) | {"align"}
    assert not ABSENT[branch] & set(names)
    assert names["align"] == 1 and spans[0]["name"] == "align"
    assert spans[0]["parent"] is None
    for s in spans:
        # on the epoch clock, inside the call, and inside its parent
        assert t0 <= s["start_ns"] <= s["end_ns"] <= t1, s
        if s["name"] == "align":
            continue
        p = spans[s["parent"]]
        assert p["name"] in PARENTS[s["name"]], (s, p)
        assert p["start_ns"] <= s["start_ns"] <= s["end_ns"] <= p["end_ns"]
    # one dispatch and one collect a launch, whatever the reads
    assert names["search.dispatch"] == names["search.collect"] \
        == stats["launches"]
    # a scan span a thread of each scanned chunk (one on the calling
    # thread in the serial escalation), its CPU within its wall
    native = [i for i, s in enumerate(spans) if s["name"] == "dbounds.native"]
    scans = [s for s in spans if s["name"] == "dbounds.scan"]
    assert len(scans) == sum(spans[i]["threads"] for i in native)
    for i in native:
        kids = [s for s in scans if s["parent"] == i]
        assert len(kids) == spans[i]["threads"]
    for s in scans:
        assert 0 <= s["cpu_ns"] <= s["end_ns"] - s["start_ns"] + 1_000_000
    # on the CPU no device D pass launches the D-bound kernel
    assert all(s["kernel"] == 0 for s in spans
               if s["name"] == "dbounds.device")
    dbounds_s = sum(s["end_ns"] - s["start_ns"] for s in spans
                    if s["name"] == "dbounds") / 1e9
    assert abs(stats["t_dbounds"] - dbounds_s) <= 1e-3
    if branch == "queued_escalation":
        assert [spans[i]["threads"] for i in native] == [1]
        assert spans[native[0]]["reads"] > 0
    if branch == "queued_probe_skip":
        assert all(spans[i]["threads"] == 2 for i in native)
    # each tier says its rung (in order), lanes and reads, as the tier log
    # does, and whether it streamed: the streamed branch's first tier only
    tiers = [s for s in spans if s["name"] == "tier"]
    assert all(set(TIER_KEYS) <= set(s) for s in tiers)
    assert [s["rung"] for s in tiers] == list(range(len(tiers)))
    assert [(s["lanes"], s["reads"]) for s in tiers] == [
        (t["B"], t["reads"]) for t in stats["tiers"]]
    assert [s["streamed"] for s in tiers] == [
        int(branch == "streamed" and r == 0) for r in range(len(tiers))]
    assert (len(tiers) >= 2) == (branch in DEEP)
    if branch in DEEP:
        assert tiers[-1]["rung"] >= 1 and 0 < tiers[-1]["reads"] \
            < tiers[0]["reads"]
    if branch == "streamed":
        # the probe's piece, then scan pieces inside the first tier
        assert stats["streamed"] is True
        pieces = [s for s in spans if s["name"] == "dbounds"]
        assert spans[pieces[0]["parent"]]["name"] == "align"
        assert len(pieces) >= 3
        assert {spans[s["parent"]]["name"] for s in pieces[1:]} == {"tier"}


@pytest.mark.parametrize("branch", sorted(BRANCHES))
def test_without_stats_nothing_is_recorded(branch_run, branch, monkeypatch):
    made: list = []

    class Seen(Spans):
        def __init__(self, stats):
            super().__init__(stats)
            made.append(self)

    monkeypatch.setattr(pipeline, "Spans", Seen)
    quiet, _, _ = branch_run(branch, None)
    assert [s.on for s in made] == [False] and made[0].spans == []
    stats: dict = {}
    loud, _, _ = branch_run(branch, stats)
    assert made[1].spans is stats["spans"] and stats["spans"]
    assert quiet == loud


def test_quick_start_settings_stream_and_match_gold(dense_world,
                                                   native_lib,  # noqa: F811
                                                   monkeypatch):
    """`align -n 4` as the quick start types it, with `-t 2` and batches
    scaled to a world of 160 reads: fixed batches, the default arena and
    D cap, no `--queued`.  The call streams its scan between the launches
    of its first tier, and its records are the gold engine's."""
    monkeypatch.setattr(t_native, "_native", native_lib)
    monkeypatch.setattr(t_native, "_tried", True)
    params = AlnParams(max_diff=4, batch_size=64, n_threads=2)
    idx, reads = dense_world["idx"], dense_world["reads"]
    stats: dict = {}
    alns = pipeline.align_reads_device(
        idx, from_fmindex(idx, device="cpu"), reads, params,
        EngineConfig(cap=int(params.arena_cap)), stats=stats, device="cpu")
    assert stats["streamed"] is True and stats["launches"] >= 3
    tiers = [s for s in stats["spans"] if s["name"] == "tier"]
    assert (tiers[0]["rung"], tiers[0]["streamed"]) == (0, 1)
    assert tiers[0]["lanes"] == 64
    assert tiers[0]["reads"] == reads.count - stats["prerouted"]
    gold = align_reads_gold(idx, reads, params)
    assert b"".join(encode_alns(a) for a in alns) == \
        b"".join(encode_alns(a) for a in gold)


def test_fixed_multigenome_call_probes_once(pipe_world,  # noqa: F811
                                            native_lib,  # noqa: F811
                                            monkeypatch):
    """A fixed multi-genome call with the gold pool up whose probe keeps
    the device D pass (d_cap 32 on a sparse world) probes once, inside the
    call's one `dbounds` span, and hands its verdict to the D pass; its
    records are the gold engine's."""
    monkeypatch.setattr(t_native, "_native", native_lib)
    monkeypatch.setattr(t_native, "_tried", True)
    idx = pipe_world["idx"]
    stats: dict = {}
    alns = pipeline.align_reads_device(
        idx, from_fmindex(idx, device="cpu"), pipe_world["reads"],
        AlnParams(max_diff=2, batch_size=128, n_threads=2),
        EngineConfig(cap=4096, acap=24), d_cap=32, stats=stats,
        device="cpu")
    names = collections.Counter(s["name"] for s in stats["spans"])
    assert not stats.get("streamed") and stats["prerouted"] > 0
    assert (names["dbounds"], names["dbounds.probe"]) == (1, 1)
    assert names["dbounds.device"] >= 1
    assert b"".join(encode_alns(a) for a in alns) == pipe_world["gold"]


def test_gold_routed_call_spans(branch_run):
    """Settings outside the device engine's domain (-o 7): the whole call
    is one wait on the gold engine."""
    stats: dict = {}
    params = AlnParams(max_diff=2, batch_size=128, n_threads=2, max_gapo=7)
    branch_run("queued_probe_skip", stats, params)
    assert stats["gold_routed"] is True
    assert [(s["name"], s["parent"]) for s in stats["spans"]] == [
        ("align", None), ("gold.drain", 0)]


def test_recorder_nests_adds_and_sums():
    stats: dict = {}
    sp = Spans(stats)
    with sp("a"):
        with sp("b", reads=3):
            sp.add("c", 10, 30, cpu_ns=5)
        with sp("b"):
            pass
    sp.add("d", 1, 2)
    assert [(s["name"], s["parent"]) for s in stats["spans"]] == [
        ("a", None), ("b", 0), ("c", 1), ("b", 0), ("d", None)]
    assert stats["spans"][1]["reads"] == 3
    assert stats["spans"][2]["cpu_ns"] == 5
    b = [s for s in stats["spans"] if s["name"] == "b"]
    assert sp.seconds("b") == sum(s["end_ns"] - s["start_ns"]
                                  for s in b) / 1e9
    assert sp.seconds("c") == 20 / 1e9
    with sp("e", K=2) as e:
        e["kernel"] = 1
    assert stats["spans"][-1]["kernel"] == 1 and stats["spans"][-1]["K"] == 2
    off = Spans(None)
    with off("a") as a:
        a["kernel"] = 1
        off.add("c", 1, 2)
    assert off.spans == [] and off.seconds("a") == 0.0
