"""FM-index construction, serialization, and query model."""

from bwbble_tpu_torch.index.fmindex import FMIndex  # noqa: F401
