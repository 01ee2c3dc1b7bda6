"""The (data, model) device mesh over torch.distributed, port of
torchain_tpu/parallel/mesh.py.

The JAX package runs every local chip from one process and lets GSPMD put
the collectives into one program over global arrays.  Torch's idiom is one
process per card (`python -m torch.distributed.run --nproc-per-node N`),
each holding its own rows of the global batch, so the collectives are
written out, and this module holds them:

  * `init_distributed` joins the process group from the variables
    `torch.distributed.run` sets (RANK, WORLD_SIZE, LOCAL_RANK,
    MASTER_ADDR, MASTER_PORT) or from an explicit `init_method`;
  * `make_mesh(MeshConfig)` lays the world out as (data, model) on a
    `DeviceMesh`, global rank d * model + m at (d, m) as the JAX package's
    `reshape(data, model)` places its devices (`mesh_layout`): a model
    group is the ranks of one data row, a data group those of one model
    column.  The model axis's sharding rules and the sharded step are in
    parallel/sharding.py;
  * a train step enters `data_parallel(mesh)`; while it is active, the
    batchnorms reduce their moments over the data group
    (ops/fused_bn.py, models/tdnn.py), dropout draws the global batch's
    mask and keeps its rows (models/tdnn.py `continuous_dropout`), and
    the chain loss divides by the global weight (ops/sharded.py).

Every collective goes through `all_reduce_`, `all_reduce_sum` (the
autograd form), `broadcast_` or `all_gather_`, over the data group or the
model group (`axis`), and each counts its calls and bytes in that group's
`Mesh.stats[axis]`.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

#: a lost peer fails the run after this long instead of hanging it
TIMEOUT = datetime.timedelta(seconds=120)


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    #: -1 = all remaining processes (one process a card)
    data: int = -1
    model: int = 1


AXES = ("data", "model")


def _counts() -> dict:
    return dict(all_reduce=0, all_reduce_bytes=0, broadcast=0, broadcast_bytes=0,
                all_gather=0, all_gather_bytes=0)


@dataclasses.dataclass
class Mesh:
    """A (data, model) layout of the processes.  `shape` is a dict as the
    JAX mesh's is; `group` is the data axis's process group (None on one
    process), `rank` this process's place on it, `host_group` a gloo group
    over the same ranks for host-side values (counts, flags, barriers);
    `model_group` and `model_rank` the same for the model axis (the ranks
    of this process's data row); `world_host_group` a gloo group over every
    rank (`host_group` where the model axis is 1; None: the default group
    is gloo already).  `stats[axis]` counts
    the collectives made through this module over each group: calls and
    bytes of each kind."""

    shape: dict
    device_mesh: object = None
    group: object = None
    host_group: object = None
    rank: int = 0
    model_group: object = None
    model_rank: int = 0
    world_host_group: object = None
    stats: dict = dataclasses.field(
        default_factory=lambda: {axis: _counts() for axis in AXES})

    @property
    def data(self) -> int:
        return self.shape["data"]

    @property
    def model(self) -> int:
        return self.shape["model"]

    @property
    def global_rank(self) -> int:
        """This process's rank in the world: data rank * model + model rank."""
        return self.rank * self.model + self.model_rank

    def group_of(self, axis: str):
        if axis not in AXES:
            raise ValueError(f"axis {axis!r}: the mesh's axes are {AXES}")
        return self.group if axis == "data" else self.model_group


def init_distributed(device, backend: str | None = None, init_method: str | None = None,
                     rank: int | None = None, world_size: int | None = None) -> torch.device:
    """Join the process group and return this process's device.

    Rank and world size come from RANK/WORLD_SIZE unless given; the
    rendezvous is `init_method` or, by default, MASTER_ADDR/MASTER_PORT
    ("env://").  `backend` None takes "nccl" for a CUDA device and "gloo"
    for the CPU; pass "gloo" for ranks that share one card (NCCL refuses
    a duplicate GPU).  `device` "cuda" resolves to cuda:LOCAL_RANK (and
    raises where LOCAL_RANK is not below the card count), which becomes
    the current device; an explicit "cuda:N" is taken as given."""
    device = torch.device(device)
    if (rank is None or world_size is None) and not {"RANK", "WORLD_SIZE"} <= set(os.environ):
        raise ValueError("RANK and WORLD_SIZE are not set: launch one process a card under "
                         "`python -m torch.distributed.run`, or pass rank and world_size")
    rank = int(os.environ["RANK"]) if rank is None else rank
    world_size = int(os.environ["WORLD_SIZE"]) if world_size is None else world_size
    if device.type == "cuda":
        if device.index is None:
            local = int(os.environ.get("LOCAL_RANK", rank))
            if local >= torch.cuda.device_count():
                raise ValueError(f"LOCAL_RANK {local} but {torch.cuda.device_count()} "
                                 "CUDA device(s): one process a card")
            device = torch.device("cuda", local)
        torch.cuda.set_device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=init_method or "env://", rank=rank,
                            world_size=world_size, timeout=TIMEOUT)
    return device


def world_size() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def mesh_layout(data: int, model: int) -> np.ndarray:
    """The global rank at each (data, model) place: rank d * model + m at
    [d, m], the row-major `reshape(data, model)` the JAX package applies to
    its device list."""
    return np.arange(data * model).reshape(data, model)


def make_mesh(cfg: MeshConfig = MeshConfig(), device_type: str | None = None) -> Mesh:
    """The (data, model) mesh over the process group's ranks (one card
    each); data=-1 takes world // model.  Without a process group the
    world is this one process."""
    n = world_size()
    model = max(1, cfg.model)
    data = cfg.data if cfg.data > 0 else n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} devices")
    if n == 1:
        return Mesh(shape=dict(data=1, model=1))
    from torch.distributed.device_mesh import DeviceMesh

    if device_type is None:
        backend = dist.get_backend()
        device_type = "cuda" if backend == "nccl" else "cpu"
    layout = mesh_layout(data, model)
    dm = DeviceMesh(device_type, torch.as_tensor(layout), mesh_dim_names=AXES)
    group, model_group = dm.get_group("data"), dm.get_group("model")
    if dist.get_backend(group) == "gloo":
        host, world_host = group, None
    else:
        # every rank takes part in making every group; each keeps its own
        host, _ = dist.new_subgroups_by_enumeration(
            [layout[:, m].tolist() for m in range(model)], timeout=TIMEOUT, backend="gloo")
        world_host = dist.new_group(backend="gloo", timeout=TIMEOUT) if model > 1 else None
    if model == 1:
        world_host = host
    return Mesh(shape=dict(data=data, model=model), device_mesh=dm, group=group,
                host_group=host, rank=dist.get_rank(group), model_group=model_group,
                model_rank=dist.get_rank(model_group), world_host_group=world_host)


def replicated(mesh: Mesh, obj):
    """Make every rank hold global rank 0's `obj` whole (the JAX package's
    NamedSharding(mesh, P()) placement): a module's parameters and buffers,
    or a list of tensors, broadcast in place, over the data group from data
    rank 0, then over the model group from model rank 0.  Returns `obj`."""
    if mesh.data * mesh.model > 1:
        tensors = ([*obj.parameters(), *obj.buffers()] if isinstance(obj, torch.nn.Module)
                   else list(obj))
        with torch.no_grad():
            for axis in AXES:
                if mesh.shape[axis] > 1:
                    for t in tensors:
                        broadcast_(mesh, t.data if isinstance(t, torch.nn.Parameter) else t,
                                   axis=axis)
    return obj


# ---------------------------------------------------------------------------
# the active data group of a step
# ---------------------------------------------------------------------------

_ACTIVE: contextvars.ContextVar[Mesh | None] = contextvars.ContextVar(
    "torchain_data_parallel", default=None)


def active_mesh() -> Mesh | None:
    """The mesh of the step running in this context, where its data axis
    is larger than 1: its batchnorms, dropout and loss are then taken over
    the global batch."""
    return _ACTIVE.get()


@contextlib.contextmanager
def data_parallel(mesh: Mesh | None):
    """Run the body as one rank's share of a data-parallel step (a no-op
    for None or a data axis of 1)."""
    tok = _ACTIVE.set(mesh if mesh is not None and mesh.data > 1 else None)
    try:
        yield
    finally:
        _ACTIVE.reset(tok)


# ---------------------------------------------------------------------------
# counted collectives over the data group
# ---------------------------------------------------------------------------


def _count(mesh: Mesh, axis: str, kind: str, nbytes: int) -> None:
    st = mesh.stats[axis]
    st[kind] += 1
    st[f"{kind}_bytes"] += nbytes


def all_reduce_(mesh: Mesh, t: torch.Tensor, axis: str = "data") -> torch.Tensor:
    """Sum `t` over the `axis` group, in place; returns it."""
    dist.all_reduce(t, group=mesh.group_of(axis))
    _count(mesh, axis, "all_reduce", t.numel() * t.element_size())
    return t


class _AllReduceSum(torch.autograd.Function):
    """y = the sum over ranks of x; the gradient of x is the sum over ranks
    of y's gradients (each rank's backward is seeded by its own part of
    the loss, so the sum is the whole derivative)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return all_reduce_(mesh, x.detach().clone())

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(ctx.mesh, g.contiguous().clone()), None


def all_reduce_sum(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """The autograd-aware sum of `x` over the data group."""
    return _AllReduceSum.apply(x, mesh)


def broadcast_(mesh: Mesh, t: torch.Tensor, src: int = 0, axis: str = "data") -> torch.Tensor:
    """Overwrite `t` with that of rank `src` of the `axis` group, in place;
    returns it."""
    group = mesh.group_of(axis)
    dist.broadcast(t, src=dist.get_global_rank(group, src), group=group)
    _count(mesh, axis, "broadcast", t.numel() * t.element_size())
    return t


def all_gather_(mesh: Mesh, t: torch.Tensor, dim: int = 0, axis: str = "model") -> torch.Tensor:
    """Every rank's `t` of the `axis` group, concatenated along `dim` in
    rank order (no gradient)."""
    t = t.detach().contiguous()
    n = mesh.shape[axis]
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t, group=mesh.group_of(axis))
    _count(mesh, axis, "all_gather", t.numel() * t.element_size() * n)
    return torch.cat(parts, dim)


def broadcast_object(mesh: Mesh, obj, src: int = 0):
    """Data rank `src`'s picklable `obj`, on every rank of the data group
    (over the host group)."""
    box = [obj]
    dist.broadcast_object_list(box, src=dist.get_global_rank(mesh.host_group, src),
                               group=mesh.host_group)
    return box[0]


def host_min(mesh: Mesh, value: int) -> int:
    """The least of an integer over the data group (host group, CPU)."""
    t = torch.tensor([value], dtype=torch.int64)
    dist.all_reduce(t, op=dist.ReduceOp.MIN, group=mesh.host_group)
    return int(t)


def barrier(mesh: Mesh) -> None:
    """Wait for every rank of the world (host group)."""
    dist.barrier(group=mesh.world_host_group)


#: the most bytes one all-reduce of `all_reduce_tensors_` carries
BUCKET_BYTES = 32 << 20


def all_reduce_tensors_(mesh: Mesh, tensors: list[torch.Tensor], axis: str = "data") -> None:
    """Sum each tensor over the `axis` group, in place: flattened into
    buckets of at most BUCKET_BYTES (one all-reduce a bucket), by dtype and
    device."""
    groups: dict = {}
    for t in tensors:
        groups.setdefault((t.dtype, t.device), []).append(t)
    for ts in groups.values():
        bucket, size = [], 0
        for t in ts + [None]:
            nbytes = 0 if t is None else t.numel() * t.element_size()
            if bucket and (t is None or size + nbytes > BUCKET_BYTES):
                flat = all_reduce_(mesh, torch.cat([b.reshape(-1) for b in bucket]), axis)
                off = 0
                for b in bucket:
                    b.copy_(flat[off:off + b.numel()].view_as(b))
                    off += b.numel()
                bucket, size = [], 0
            if t is not None:
                bucket.append(t)
                size += nbytes


# ---------------------------------------------------------------------------
# batches
# ---------------------------------------------------------------------------


def _rows(x, start: int, stop: int, batch: int):
    if isinstance(x, (np.ndarray, torch.Tensor)) and x.ndim and x.shape[0] == batch:
        return x[start:stop]
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{
            f.name: _rows(getattr(x, f.name), start, stop, batch)
            for f in dataclasses.fields(x) if f.init})
    if isinstance(x, dict):
        return {k: _rows(v, start, stop, batch) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(_rows(v, start, stop, batch) for v in x)
    return x


def _batch_rows(batch) -> int:
    feats = getattr(batch, "feats", None)
    if feats is not None:
        return int(feats.shape[0])
    if isinstance(batch, dict):
        return int(next(iter(batch.values())).shape[0])
    return int(batch.shape[0])


def shard_batch(mesh: Mesh, batch):
    """This rank's contiguous rows of a global batch (a ChainBatch, a
    dataclass, dict, tuple, array or tensor: every array whose leading
    axis is the batch is cut).  A batch the data axis does not divide
    stays whole on every rank (the JAX package's replicated fall-back):
    `ops.sharded.shardable` tells the two apart."""
    from torchain_tpu_torch.ops.sharded import shardable

    b = _batch_rows(batch)
    if not shardable(mesh, b):
        return batch
    n = b // mesh.data
    return _rows(batch, mesh.rank * n, (mesh.rank + 1) * n, b)


def global_batch_from_local(mesh: Mesh, local):
    """The global batch from every rank's rows (an all-gather, in rank
    order), for checks and evaluation.  Tensors travel over the data group
    on their device, NumPy arrays over the host group; other leaves are
    taken from this rank."""
    if mesh.data == 1:
        return local

    def gather(x):
        if isinstance(x, np.ndarray) and x.ndim:
            parts = [torch.empty_like(torch.as_tensor(x)) for _ in range(mesh.data)]
            dist.all_gather(parts, torch.as_tensor(x).contiguous(), group=mesh.host_group)
            return torch.cat(parts).numpy()
        if isinstance(x, torch.Tensor) and x.ndim:
            return all_gather_(mesh, x, 0, "data")
        if dataclasses.is_dataclass(x) and not isinstance(x, type):
            return dataclasses.replace(x, **{
                f.name: gather(getattr(x, f.name)) for f in dataclasses.fields(x) if f.init})
        if isinstance(x, dict):
            return {k: gather(v) for k, v in x.items()}
        if isinstance(x, (tuple, list)):
            return type(x)(gather(v) for v in x)
        return x

    return gather(local)
