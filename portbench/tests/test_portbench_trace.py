"""The reduction of a device trace, on events made by hand: the union of
each card's intervals inside the window, averaged over the cards, its operations by time, and the
idle gaps named by the harness span open at their middle."""

from portbench.trace import Spans, reduce

MS = 1_000_000      # nanoseconds


def test_busy_union_ops_and_gaps():
    spans = [(0, 100 * MS, "window"), (0, 10 * MS, "parse"),
             (10 * MS, 90 * MS, "align"), (90 * MS, 100 * MS, "write")]
    events = [("k1", 20 * MS, 30 * MS, 0), ("k1", 25 * MS, 40 * MS, 0),
              ("k2", 60 * MS, 70 * MS, 0),
              ("k2", -5 * MS, 5 * MS, 0),       # starts before the window
              ("k3", 200 * MS, 210 * MS, 0)]    # after it: left out
    t = reduce(events, spans)
    # busy: [0, 5] + [20, 40] + [60, 70] = 35 ms of 100
    assert abs(t.busy_s - 0.035) < 1e-12 and abs(t.window_s - 0.1) < 1e-12
    assert [n for n, _ in t.device_ops] == ["k1", "k2"]
    assert abs(t.device_ops[0][1] - 0.025) < 1e-12     # 10 + 15 ms
    assert abs(t.device_ops[1][1] - 0.015) < 1e-12     # 10 + 5 ms
    # gaps: [5, 20] parse/align -> middle 12.5 in align; [40, 60] align;
    # [70, 100] middle 85 in align
    assert [g[0] for g in t.idle_gaps] == ["align", "align", "align"]
    assert [round(g[1], 9) for g in t.idle_gaps] == [0.03, 0.02, 0.015]


def test_busy_is_the_mean_over_the_cards():
    spans = [(0, 100 * MS, "window"), (0, 100 * MS, "align")]
    events = [("k", 0, 40 * MS, 0), ("k", 20 * MS, 60 * MS, 1),
              ("k", 50 * MS, 70 * MS, 1)]
    t = reduce(events, spans, cards=2)
    # card 0 busy 40 ms, card 1 [20, 70] = 50 ms: 45 ms on the mean
    assert abs(t.busy_s - 0.045) < 1e-12
    # no card busy in [70, 100]
    assert [round(g[1], 9) for g in t.idle_gaps] == [0.03]
    # a card with no activity counts as idle
    t4 = reduce(events, spans, cards=4)
    assert abs(t4.busy_s - 0.0225) < 1e-12


def test_nothing_to_read():
    assert reduce([("k", 0, 1, 0)], []) is None
    assert reduce([("k", 200, 300, 0)], [(0, 100, "window")]) is None


def test_spans_only_when_tracing():
    off, on = Spans(False), Spans(True)
    with off("parse"):
        pass
    with on("parse"):
        pass
    assert off.spans == [] and [n for _, _, n in on.spans] == ["parse"]
