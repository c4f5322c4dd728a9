"""Milliseconds a thousand reads keep the card busy: the union of the
card's activity intervals over the traced window (`device_idle_pct`'s
busy time), over all the window's reads; nothing on a run without a
card.  The card time a read costs, whatever the host does meanwhile."""

UNIT = "ms/kread"
LAYER = "end to end"
SOURCE = "device_trace"
MOVES = None


def read(run):
    t = run.trace
    if t is None or t.busy_s <= 0:
        return None
    return run.per_kread_ms(t.busy_s)
