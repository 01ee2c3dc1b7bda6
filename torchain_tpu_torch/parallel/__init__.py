"""parallel — the data axis of the device mesh over torch.distributed, port
of torchain_tpu/parallel (one process a card; the model axis is not
ported yet)."""

from torchain_tpu_torch.parallel.mesh import (
    Mesh,
    MeshConfig,
    active_mesh,
    data_parallel,
    global_batch_from_local,
    init_distributed,
    make_mesh,
    replicated,
    shard_batch,
)

__all__ = [
    "Mesh",
    "MeshConfig",
    "active_mesh",
    "data_parallel",
    "global_batch_from_local",
    "init_distributed",
    "make_mesh",
    "replicated",
    "shard_batch",
]
