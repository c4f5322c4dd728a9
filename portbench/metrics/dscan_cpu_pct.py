"""Share of the native D scan's thread time spent on a CPU: the thread CPU
time of the program's `dbounds.scan` spans over, summed over its
`dbounds.native` spans, the threads a chunk times the chunk's wall time
(`stats["spans"]`, all the window's calls).  Below 100 % the scan threads
wait: on the GIL, at the chunk's barrier, or for a core."""

UNIT = "%"
LAYER = "D bounds"
SOURCE = "program_span"
MOVES = "card_ms_per_kread"


def read(run):
    cpu = wall = 0
    for c in run.calls:
        for s in c.stats.get("spans") or ():
            if s["name"] == "dbounds.native":
                wall += s["threads"] * (s["end_ns"] - s["start_ns"])
            elif s["name"] == "dbounds.scan":
                cpu += s["cpu_ns"]
    return 100.0 * cpu / wall if wall > 0 else None
