"""One reader a metric, `<name>.py`, found by the name in BENCHMARK.json:
UNIT, LAYER, SOURCE, MOVES, and `read(run)`, which returns the metric from
a `portbench.record.Run`, or None where there is nothing to read."""
