"""Milliseconds a thousand reads the host waited on a launch of the
streamed scan-and-launch tier, and copied its results, after the scan
piece it ran meanwhile: the summed wall time of the program's
`search.collect` spans inside `tier` spans whose `streamed` is 1
(`stats["spans"]`), over the window's reads.  Near 0 the scan sets the
pace; large, the card does.  Nothing where no call streamed, so a cell
that stops taking the branch shows."""

UNIT = "ms/kread"
LAYER = "search (streamed scan-and-launch)"
SOURCE = "program_span"
MOVES = "reads_per_s"


def read(run):
    total, seen = 0, False
    for c in run.calls:
        spans = c.stats.get("spans") or ()
        for s in spans:
            if s["name"] == "tier" and s.get("streamed") == 1:
                seen = True
            elif s["name"] == "search.collect" and s["parent"] is not None:
                p = spans[s["parent"]]
                if p["name"] == "tier" and p.get("streamed") == 1:
                    total += s["end_ns"] - s["start_ns"]
    return run.per_kread_ms(total / 1e9) if seen else None
