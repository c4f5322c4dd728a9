"""`deep_tier_ms_per_kread` in the cells whose end-to-end time is the
card's (`card_ms_per_kread`)."""

from portbench.metrics.deep_tier_ms_per_kread import (  # noqa: F401
    LAYER, SOURCE, UNIT, read)

MOVES = "card_ms_per_kread"
