"""parallel layer of the PyTorch port (see the matching rankpo_tpu.parallel):
data-parallel gradient exchange and ZeRO optimizer sharding, the
tensor-parallel rules (``sharding``), sharded parameters (``fsdp``) and
ring attention (``ring_attention``)."""

from rankpo_tpu_torch.parallel.ring_attention import (
    context_parallel_attention,
    ring_attention_local,
    ring_flash_attention_local,
)
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
    "context_parallel_attention",
    "partition_params",
    "ring_attention_local",
    "ring_flash_attention_local",
]
