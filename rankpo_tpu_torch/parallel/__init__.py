"""parallel layer of the PyTorch port (see the matching rankpo_tpu.parallel):
data-parallel gradient exchange and ZeRO optimizer sharding. Ring attention
and tensor-parallel rules are not ported (ROADMAP.md Queue 1 item 8b)."""

from rankpo_tpu_torch.parallel.sharding import (
    ShardedOptimizer,
    all_reduce_mean_,
    broadcast_from_owners_,
    partition_params,
)

__all__ = [
    "ShardedOptimizer",
    "all_reduce_mean_",
    "broadcast_from_owners_",
    "partition_params",
]
