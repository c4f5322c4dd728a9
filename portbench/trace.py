"""The traced run's device trace: `torch.profiler` records the card's
activity over the window (CUDA activity only: recording every host
operation as well made the trace of a window take minutes to stop and to
read), and the harness records its own spans (`window`, `parse`, `align`,
`write`) on the host clock, in the nanoseconds since the epoch that the
profiler's events carry too.  The card's busy time is the union of its
activity intervals inside the window (the arithmetic of chip_smoke.py's
`main_path.profile`), averaged over the cards a run uses; each idle gap
between them is named by the harness span open at its middle."""

from __future__ import annotations

import bisect
import contextlib
import time

from portbench.record import Trace

NAME_CHARS = 160        # of a kernel's name in the breakdown


class Spans:
    """The harness's spans, (start ns, end ns, name), when tracing."""

    def __init__(self, on: bool):
        self.on = on
        self.spans: list = []

    @contextlib.contextmanager
    def __call__(self, name: str):
        if not self.on:
            yield
            return
        t = time.time_ns()
        try:
            yield
        finally:
            self.spans.append((t, time.time_ns(), name))


def profiler():
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CUDA])


def device_events(prof) -> list:
    """(name, start ns, end ns, card) of each activity on a card."""
    from torch.autograd import DeviceType
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            s = e.start_ns()
            out.append((e.name(), s, s + e.duration_ns(), e.device_index()))
    return out


def _union(spans: list) -> list:
    out: list = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def reduce(events: list, spans: list, cards: int = 1) -> Trace | None:
    """Busy and idle time of the `cards` cards over the `window` span, from
    their events (name, start ns, end ns, card); None when there is no
    window or no activity in it.  The busy time is each card's union of
    its intervals, averaged over the cards; the idle gaps are those in
    which no card was busy."""
    window = next(((a, b) for a, b, n in spans if n == "window"), None)
    if window is None:
        return None
    w0, w1 = window
    clipped = [(n, max(a, w0), min(b, w1), d) for n, a, b, d in events
               if b > w0 and a < w1]
    if not clipped:
        return None
    per_card: dict = {}
    for _, a, b, d in clipped:
        per_card.setdefault(d, []).append([a, b])
    busy_s = sum(sum(b - a for a, b in _union(iv))
                 for iv in per_card.values()) / 1e9 / cards
    busy = _union([[a, b] for _, a, b, _ in clipped])
    by_name: dict = {}
    for n, a, b, _ in clipped:
        by_name[n] = by_name.get(n, 0) + (b - a)
    gaps, t = [], w0
    for a, b in busy + [[w1, w1]]:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    host = sorted((a, b, n) for a, b, n in spans if n != "window")
    starts = [a for a, _, _ in host]
    named = []
    for a, b in gaps:
        mid = (a + b) / 2
        k = bisect.bisect_right(starts, mid) - 1
        inside = k >= 0 and host[k][1] >= mid
        named.append([host[k][2] if inside else "harness", (b - a) / 1e9])
    named.sort(key=lambda g: -g[1])
    ops = sorted(([n[:NAME_CHARS], s / 1e9] for n, s in by_name.items()),
                 key=lambda o: -o[1])
    return Trace(busy_s=busy_s,
                 window_s=(w1 - w0) / 1e9, device_ops=ops[:10],
                 idle_gaps=named[:10])
