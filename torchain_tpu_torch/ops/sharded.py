"""The chain loss over the data axis, port of torchain_tpu/ops/sharded.py.

In the JAX package `shard_map` runs the denominator and numerator
recursions on each chip's rows (sequences are independent in both, so the
kernels need no communication) and GSPMD sums the statistics outside.  In
the port every rank already holds only its rows, so each runs the
single-card kernels on them as they are; what is left is the sums: the
loss of the global batch is -(sum of every rank's objective terms) / (the
global weight), and this module all-reduces those sums.

The JAX module also keeps `in_sharded_region()`, which its numerator's
dispatch reads in place of the device count.  No dispatch of the port reads
the device count (each rank sees one card and its own rows), so the port
has no such flag.
"""

from __future__ import annotations

import torch

from torchain_tpu_torch.parallel.mesh import Mesh, all_reduce_


def shardable(mesh: Mesh | None, batch: int) -> bool:
    """Whether a global batch of `batch` rows is cut over the mesh's data
    axis: a data axis larger than 1 that divides it (a batch it does not
    divide is computed whole on every rank, with no communication)."""
    if mesh is None:
        return False
    data = mesh.shape.get("data", 1)
    return data > 1 and batch % data == 0


def reduce_loss_sums(mesh: Mesh, sums: torch.Tensor) -> torch.Tensor:
    """The global chain-loss sums (objf, l2_term, oor_term, xent_objf,
    weight, num_failed; each un-normalized, [6]) from this rank's: one
    all-reduce.  The result carries no gradient."""
    return all_reduce_(mesh, sums.detach().float().clone())
