"""Spans of one alignment call: where its wall time goes, phase by phase.

A span is a dict: `name`; `start_ns` and `end_ns` on `time.time_ns()`, the
epoch clock that torch.profiler's device events carry too, so a span can be
laid beside the device trace; `parent`, the index in the same list of the
span that encloses it (None for the outermost); and whatever the caller adds
(`reads`, `K`, `threads`; `cpu_ns` on a scan thread's span: that thread's
CPU time over the span, `time.thread_time_ns()`).

The recorder travels with the call: `Spans(stats)` keeps its list under
`stats["spans"]`, and `Spans(None)` records nothing.  Spans nest on the
calling thread.  A worker thread reads `clock()` itself and hands its
readings back; the calling thread records them with `add`.  Nothing here
reaches torch.profiler.
"""

from __future__ import annotations

import contextlib
import time


def clock() -> tuple[int, int]:
    """(wall ns, the calling thread's CPU ns), for a span a worker thread
    times itself."""
    return time.time_ns(), time.thread_time_ns()


class Spans:
    """The spans of one call, under `stats["spans"]`; with `stats=None`
    every method does nothing."""

    def __init__(self, stats: dict | None):
        self.on = stats is not None
        self.spans: list[dict] = []
        self._open: list[int] = []      # indices of the open spans
        if self.on:
            stats["spans"] = self.spans

    def _parent(self) -> int | None:
        return self._open[-1] if self._open else None

    @contextlib.contextmanager
    def __call__(self, name: str, **attrs):
        """A span around the `with` block, inside the innermost open one."""
        if not self.on:
            yield
            return
        i = len(self.spans)
        self.spans.append(dict(name=name, start_ns=time.time_ns(),
                               end_ns=None, parent=self._parent(), **attrs))
        self._open.append(i)
        try:
            yield
        finally:
            self._open.pop()
            self.spans[i]["end_ns"] = time.time_ns()

    def add(self, name: str, start_ns: int, end_ns: int, **attrs) -> None:
        """A span timed elsewhere (a worker thread), inside the innermost
        open one."""
        if self.on:
            self.spans.append(dict(name=name, start_ns=start_ns,
                                   end_ns=end_ns, parent=self._parent(),
                                   **attrs))

    def seconds(self, name: str) -> float:
        """The summed duration of the closed spans called `name`."""
        return sum(s["end_ns"] - s["start_ns"] for s in self.spans
                   if s["name"] == name and s["end_ns"] is not None) / 1e9


OFF = Spans(None)       # records nothing: the default of the helpers
