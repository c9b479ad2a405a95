from .mesh import (
    batch_sharding, host_shard_list, initialize_distributed, make_mesh,
    replicated_sharding, shard_batch,
)

__all__ = [
    "make_mesh", "batch_sharding", "replicated_sharding", "shard_batch",
    "initialize_distributed", "host_shard_list",
]
