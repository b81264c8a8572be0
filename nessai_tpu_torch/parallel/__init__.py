"""Device meshes. Counterpart of ``nessai_tpu/parallel``."""

from .mesh import (
    Mesh,
    data_sharding,
    get_mesh,
    make_dp_train_step,
    pad_to_multiple,
    replicated_sharding,
    shard_batch,
    sharded_batch_evaluate,
)

__all__ = [
    "Mesh",
    "get_mesh",
    "data_sharding",
    "replicated_sharding",
    "shard_batch",
    "pad_to_multiple",
    "make_dp_train_step",
    "sharded_batch_evaluate",
]
