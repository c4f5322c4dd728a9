"""`reads_per_s` in the cells whose end-to-end time is the card's: all
the reads of all the window's calls over the time from the window's start
to the end of its last call, a per-layer reading there."""

from portbench.metrics.reads_per_s import read  # noqa: F401

UNIT = "reads/s"
LAYER = "whole call"
SOURCE = "host_clock"
MOVES = "card_ms_per_kread"
