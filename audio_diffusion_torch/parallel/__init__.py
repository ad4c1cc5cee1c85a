from .inference import sample_length_sharded
from .mesh import (create_mesh, global_batch, param_sharding_rules,
                   shard_batch, shard_params)
from .train_step import TrainState, make_train_step

__all__ = [
    "create_mesh",
    "shard_batch",
    "global_batch",
    "shard_params",
    "param_sharding_rules",
    "make_train_step",
    "sample_length_sharded",
    "TrainState",
]
