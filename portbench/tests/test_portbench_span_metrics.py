"""The readers of the program's spans (`stats["spans"]`) against runs made
by hand: each value worked out from the spans, and nothing where a call
recorded none (a program that records no spans)."""

import pytest

from portbench.cell import metric_reader
from portbench.record import Call, Run

MS = 1_000_000          # ns


def _span(name, start, end, parent, **kw):
    return dict(name=name, start_ns=start * MS, end_ns=end * MS,
                parent=parent, **kw)


def _call(reads, spans):
    return Call(reads=reads, stats={"spans": spans}, ok=True)


def _run(*calls):
    return Run(cell="c", config={}, traffic={}, calls=list(calls),
               window_s=1.0)


# one call of 1 000 reads, in ms: align 0-100; dbounds 2-60 with two scan
# chunks (2 threads over 20 ms, 3 threads over 10 ms); a tier 60-90 with a
# dispatch at 61 and an assembly of 6 ms; another assembly of 4 ms and a
# gold drain of 7 ms under align
CALL_A = [
    _span("align", 0, 100, None),
    _span("gold.start", 0, 2, 0),
    _span("dbounds", 2, 60, 0),
    _span("dbounds.native", 10, 30, 2, threads=2, reads=500),
    _span("dbounds.scan", 10, 30, 3, cpu_ns=15 * MS),
    _span("dbounds.scan", 10, 25, 3, cpu_ns=5 * MS),
    _span("dbounds.native", 30, 40, 2, threads=3, reads=500),
    _span("dbounds.scan", 30, 40, 6, cpu_ns=10 * MS),
    _span("dbounds.scan", 30, 40, 6, cpu_ns=10 * MS),
    _span("dbounds.scan", 30, 38, 6, cpu_ns=5 * MS),
    _span("tier", 60, 90, 0),
    _span("search.dispatch", 61, 62, 10),
    _span("search.collect", 62, 80, 10),
    _span("assemble", 80, 86, 10),
    _span("assemble", 90, 94, 0),
    _span("gold.drain", 94, 101, 0),
]
# a second call of 1 000 reads that dispatched nothing: all 50 ms count
# before its (absent) first launch
CALL_B = [_span("align", 200, 250, None), _span("gold.drain", 205, 249, 0)]


@pytest.mark.parametrize("name, want", [
    # (15 + 5 + 10 + 10 + 5) ms of CPU over 2 x 20 + 3 x 10 ms of threads
    ("dscan_cpu_pct", 100.0 * 45 / 70),
    # (61 - 0) + 50 ms over 2 000 reads
    ("prelaunch_ms_per_kread", 111 / 2),
    ("prelaunch_ms_per_kread.card", 111 / 2),
    # (6 + 4) ms over 2 000 reads
    ("assemble_ms_per_kread", 10 / 2),
    ("assemble_ms_per_kread.card", 10 / 2),
    # (7 + 44) ms over 2 000 reads
    ("gold_wait_ms_per_kread", 51 / 2),
])
def test_reader_value_by_hand(name, want):
    run = _run(_call(1000, CALL_A), _call(1000, CALL_B))
    assert metric_reader(name).read(run) == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("name", [
    "dscan_cpu_pct", "prelaunch_ms_per_kread",
    "prelaunch_ms_per_kread.card", "assemble_ms_per_kread",
    "assemble_ms_per_kread.card", "gold_wait_ms_per_kread"])
def test_reader_without_spans_reads_nothing(name):
    reader = metric_reader(name)
    # a program that records no spans: counters only
    run = _run(Call(reads=1000, stats={"t_dbounds": 1.0}, ok=True))
    assert reader.read(run) is None
    assert reader.read(_run()) is None
    # spans without a native scan: no share of the scan's threads
    if name == "dscan_cpu_pct":
        assert reader.read(_run(_call(1000, CALL_B))) is None
