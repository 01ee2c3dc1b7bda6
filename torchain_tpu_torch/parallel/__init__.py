"""parallel — the (data, model) device mesh over torch.distributed, port of
torchain_tpu/parallel (one process a card): the data axis (mesh.py) and the
model axis's sharding rules and sharded leaves (sharding.py)."""

from torchain_tpu_torch.parallel.mesh import (
    Mesh,
    MeshConfig,
    active_mesh,
    data_parallel,
    global_batch_from_local,
    init_distributed,
    make_mesh,
    mesh_layout,
    replicated,
    shard_batch,
)
from torchain_tpu_torch.parallel.sharding import (
    gathered_state_dict,
    load_gathered_state_dict,
    param_sharding_rules,
    shard_params,
)

__all__ = [
    "Mesh",
    "MeshConfig",
    "active_mesh",
    "data_parallel",
    "gathered_state_dict",
    "global_batch_from_local",
    "init_distributed",
    "load_gathered_state_dict",
    "make_mesh",
    "mesh_layout",
    "param_sharding_rules",
    "replicated",
    "shard_batch",
    "shard_params",
]
