"""Milliseconds a thousand reads from the start of `align_reads_device` to
the start of its first search dispatch (the program's `align` and first
`search.dispatch` spans, `stats["spans"]`; the whole call where it
dispatched nothing), summed over the window's calls: what the card waits
for its first search work."""

UNIT = "ms/kread"
LAYER = "D bounds and routing"
SOURCE = "program_span"
MOVES = "reads_per_s"


def read(run):
    total, seen = 0, False
    for c in run.calls:
        spans = c.stats.get("spans")
        if not spans:
            continue
        seen = True
        align = next(s for s in spans if s["name"] == "align")
        first = min((s["start_ns"] for s in spans
                     if s["name"] == "search.dispatch"),
                    default=align["end_ns"])
        total += first - align["start_ns"]
    return run.per_kread_ms(total / 1e9) if seen else None
