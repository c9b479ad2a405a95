from .mesh import host_shard_list

__all__ = ["host_shard_list"]
