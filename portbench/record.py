"""What a run hands its per-layer metric readers: each call of the window
(its reads, the harness's spans around parse, align and write, the
program's stats dict, the `.aln` it wrote) and the reduced device trace."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Call:
    reads: int
    parse_s: float = 0.0
    align_s: float = 0.0
    write_s: float = 0.0
    cpu_s: float = 0.0          # the process's CPU seconds in the call
    gc_s: float = 0.0           # the collector's seconds in the call
    stats: dict = dataclasses.field(default_factory=dict)
    aln_path: str | None = None
    ok: bool = False


@dataclasses.dataclass
class Trace:
    busy_s: float               # each card's busy union, mean over cards
    window_s: float             # the traced window, in the trace's clock
    device_ops: list            # [name, seconds], most time first
    idle_gaps: list             # [span open on the host, seconds], longest


@dataclasses.dataclass
class Run:
    cell: str
    config: dict
    traffic: dict
    calls: list
    window_s: float
    setup_s: float = 0.0
    device: str = "cuda"        # the type of the device the run used
    trace: Trace | None = None

    @property
    def reads(self) -> int:
        return sum(c.reads for c in self.calls)

    def stat_sum(self, key: str) -> float | None:
        """The sum of a stats counter over the calls that report it."""
        vals = [c.stats[key] for c in self.calls if c.stats.get(key)
                is not None]
        return float(sum(vals)) if vals else None

    def per_kread_ms(self, seconds: float | None) -> float | None:
        if seconds is None or self.reads == 0:
            return None
        return seconds * 1e6 / self.reads
