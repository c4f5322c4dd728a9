"""Milliseconds a thousand reads in the deep tiers: the summed wall time of
the program's `tier` spans whose `rung` is 1 or more (`stats["spans"]`),
over the window's reads; 0 where the window's calls ran no deep rung, and
nothing where no `tier` span says its rung (a program whose spans carry
none)."""

UNIT = "ms/kread"
LAYER = "search (deep tier)"
SOURCE = "program_span"
MOVES = "reads_per_s"


def read(run):
    total, seen = 0, False
    for c in run.calls:
        for s in c.stats.get("spans") or ():
            if s["name"] == "tier" and "rung" in s:
                seen = True
                if s["rung"] >= 1:
                    total += s["end_ns"] - s["start_ns"]
    return run.per_kread_ms(total / 1e9) if seen else None
