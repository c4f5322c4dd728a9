"""Milliseconds a thousand reads in the assembly of the records from the
launches' results: the program's `assemble` spans (`stats["spans"]`),
summed over the window's calls."""

UNIT = "ms/kread"
LAYER = "gold pool and assembly"
SOURCE = "program_span"
MOVES = "reads_per_s"


def span_seconds(run, name):
    """The summed seconds of the spans called `name` in the calls that
    recorded spans; None where no call did."""
    calls = [c.stats["spans"] for c in run.calls if c.stats.get("spans")]
    if not calls:
        return None
    return sum(s["end_ns"] - s["start_ns"] for spans in calls
               for s in spans if s["name"] == name) / 1e9


def read(run):
    return run.per_kread_ms(span_seconds(run, "assemble"))
