"""Sharding rules, out-dim tensor parallelism, the activation policy and
the sharded training state of the port (port of ``repro/parallel/``)."""
from .sharding import (axis_sizes, batch_spec, cache_spec, fsdp_axes,
                       local_shard, param_shardings, param_spec,
                       sparse_weight_specs, tree_paths)
from .fsdp import (StateSharding, TrainMesh, gather_tree, shard_tree,
                   state_sharding, unshard_tree)
from .policy import activation_sharding, divides, seq_sharded, shard, suspended
from .tensor_parallel import (ColShard, HeadShard, ModelAxis, RowShard,
                              StateShard, all_sum, all_to_all, gather_blocks)
