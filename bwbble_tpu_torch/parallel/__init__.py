from bwbble_tpu_torch.parallel.shard import (  # noqa: F401
    make_mesh, pad_index_for_tp, sharded_align_step, sharded_inexact_search,
)
