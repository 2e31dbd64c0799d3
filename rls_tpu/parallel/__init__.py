from .mesh import (
    batch_sharding,
    make_mesh,
    row_sharded_operator,
    shard_batch,
    solve_batched_sharded,
)
from .multihost import global_mesh, initialize_multihost, is_multihost

__all__ = [
    "make_mesh",
    "batch_sharding",
    "shard_batch",
    "row_sharded_operator",
    "solve_batched_sharded",
    "initialize_multihost",
    "is_multihost",
    "global_mesh",
]
