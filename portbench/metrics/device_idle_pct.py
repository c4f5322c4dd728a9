"""Share of the traced window in which no operation ran on the card:
1 - the union of the CUDA activity intervals over the window."""

UNIT = "%"
LAYER = "device"
SOURCE = "device_trace"
MOVES = "reads_per_s"


def read(run):
    t = run.trace
    if t is None or t.busy_s <= 0 or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
