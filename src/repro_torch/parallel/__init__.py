"""Sharding rules and out-dim tensor parallelism of the port (port of
``repro/parallel/``'s serving half; the training policy waits for ROADMAP
A12c)."""
from .sharding import (axis_sizes, batch_spec, cache_spec, fsdp_axes,
                       local_shard, param_shardings, param_spec,
                       sparse_weight_specs, tree_paths)
from .tensor_parallel import (ColShard, HeadShard, ModelAxis, RowShard,
                              StateShard)
