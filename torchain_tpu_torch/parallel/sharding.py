"""The model axis of the mesh: the JAX package's parameter sharding rules
(torchain_tpu/parallel/mesh.py `param_sharding_rules`, `shard_params`) on a
torch module, one process a card.

In the JAX package GSPMD partitions the step around the sharded leaves.
Here each rank holds its model rank's block of every sharded leaf as the
`Parameter` itself, so its optimizer state has the shard's shape, and the
communication is written out:

  * the conformer's feed-forward half-steps, whose two kernels the rule
    always shards as a column then a row block (`ffn*_in [D, F]` over F,
    `ffn*_out [F, D]` over F), run split over the model group
    (`models/conformer.py`): the input enters through `to_model_group`
    (identity; its gradient summed over the group), each rank computes
    its hidden columns' float32 partial, and `sum_over_model_group`
    all-reduces it (gradient: identity).  The replicated `b1` is used by
    slices, so its gradient is summed over the model group after the
    backward (`model_grad_sums`);
  * every other sharded leaf is gathered on use: a hook all-gathers it
    over the model group before its module's forward (GSPMD's gather
    before a custom call), and the gradient keeps this rank's slice, with
    no communication (the ranks of a model group see the same rows);
  * the step's gradient norm counts a replicated leaf once and sums a
    sharded leaf's squares over the model group (`squared_norms`); the
    optimizers act element by element on the shards, NGSGD on the whole
    leaf gathered (`gather_leaf_value`).

A sharded `Parameter` carries `model_axis` (the sharded axis),
`model_mesh` and `full_shape`; `gathered_state_dict` gives the whole
tensors under the unsharded keys, and `load_gathered_state_dict` takes
them back into any layout.
"""

from __future__ import annotations

import numpy as np
import torch

from torchain_tpu_torch.parallel.mesh import Mesh, all_gather_, all_reduce_, all_reduce_tensors_

#: the JAX rule's default threshold: leaves of fewer elements stay whole
MIN_SHARD_SIZE = 2**18


def leaf_rule(shape, m: int, min_shard_size: int = MIN_SHARD_SIZE) -> int | None:
    """The JAX rule for one leaf of `shape` on a model axis of `m`: the
    axis sharded over "model" (the largest, the first on a tie) for a leaf
    of 2 or more dimensions, at least `min_shard_size` elements and that
    axis divisible by `m`; else None (replicated)."""
    size = int(np.prod(shape)) if len(shape) else 1
    if m == 1 or len(shape) < 2 or size < min_shard_size:
        return None
    axis = int(np.argmax(shape))
    return axis if shape[axis] % m == 0 else None


def param_sharding_rules(mesh, model: torch.nn.Module,
                         min_shard_size: int = MIN_SHARD_SIZE) -> dict[str, int | None]:
    """For each parameter name of `model` (flax's names, dotted), the axis
    sharded over the mesh's model axis, or None.  A leaf already sharded
    is judged by its whole shape."""
    return {name: leaf_rule(full_shape(p), mesh.model, min_shard_size)
            for name, p in model.named_parameters()}


def model_axis(p: torch.Tensor) -> int | None:
    """The axis a parameter is sharded along over the model group, or None."""
    return getattr(p, "model_axis", None)


def full_shape(p: torch.Tensor) -> tuple[int, ...]:
    """The whole leaf's shape of a parameter (sharded or not)."""
    return tuple(getattr(p, "full_shape", p.shape))


def _slice(mesh: Mesh, t: torch.Tensor, axis: int) -> torch.Tensor:
    n = t.shape[axis] // mesh.model
    return t.narrow(axis, mesh.model_rank * n, n)


class _GatherLeaf(torch.autograd.Function):
    """The whole leaf from every model rank's block; the gradient keeps this
    rank's block (each rank of the group computed the same whole one)."""

    @staticmethod
    def forward(ctx, shard, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return all_gather_(mesh, shard, axis, "model")

    @staticmethod
    def backward(ctx, g):
        return _slice(ctx.mesh, g, ctx.axis).contiguous(), None, None


def whole(p: torch.Tensor) -> torch.Tensor:
    """A parameter as a whole tensor: gathered over the model group
    (differentiably) where it is sharded, else itself."""
    axis = model_axis(p)
    if axis is None:
        return p
    return _GatherLeaf.apply(p, p.model_mesh, axis)


def gather_leaf_value(p: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """`t` (p's value or gradient, p's shard shape) gathered to the whole
    leaf over the model group where p is sharded (no gradient)."""
    axis = model_axis(p)
    return t if axis is None else all_gather_(p.model_mesh, t, axis, "model")


def shard_of(p: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """This rank's block of the whole-leaf tensor `t` where p is sharded,
    else `t`."""
    axis = model_axis(p)
    return t if axis is None else _slice(p.model_mesh, t, axis)


class _ToModelGroup(torch.autograd.Function):
    """Identity forward; the gradient is summed over the model group (the
    input of a split product: each rank's gradient covers its columns)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(ctx.mesh, g.contiguous().clone(), "model"), None


class _SumOverModelGroup(torch.autograd.Function):
    """The sum over the model group of each rank's partial; the gradient
    passes to every partial unchanged."""

    @staticmethod
    def forward(ctx, x, mesh):
        return all_reduce_(mesh, x.detach().contiguous().clone(), "model")

    @staticmethod
    def backward(ctx, g):
        return g, None


def to_model_group(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    return _ToModelGroup.apply(x, mesh)


def sum_over_model_group(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    return _SumOverModelGroup.apply(x, mesh)


def _gather_hooks(module: torch.nn.Module, names: list[str]) -> None:
    """Hooks that put each named leaf of `module` whole in place of its
    shard for the module's forward, and the shard back after it."""

    def before(mod, args):
        mod._model_shards_held = {n: mod._parameters[n] for n in names}
        for n in names:
            mod._parameters[n] = whole(mod._model_shards_held[n])

    def after(mod, args, out):
        held = mod.__dict__.pop("_model_shards_held", None)
        if held:
            mod._parameters.update(held)

    module.register_forward_pre_hook(before)
    module.register_forward_hook(after, always_call=True)


def shard_params(mesh: Mesh, model: torch.nn.Module,
                 min_shard_size: int = MIN_SHARD_SIZE) -> torch.nn.Module:
    """Shard `model`'s leaves over the mesh's model axis by
    `param_sharding_rules`, in place: each sharded leaf becomes this model
    rank's contiguous block (a new `Parameter`: build the optimizer after
    this).  Modules with a `split_over_model(mesh, axes)` method (the
    conformer block) take the leaves they compute on as shards; every
    other sharded leaf is gathered on use.  The replicated leaves must
    already be equal on every rank (`parallel.replicated`).  Returns
    `model`."""
    if mesh.model == 1:
        return model
    if getattr(model, "_model_sharded", False):
        raise ValueError("the model is sharded already")
    axes = {k: v for k, v in param_sharding_rules(mesh, model, min_shard_size).items()
            if v is not None}
    split: set[str] = set()
    for prefix, module in model.named_modules():
        take = getattr(module, "split_over_model", None)
        if take is None:
            continue
        pre = f"{prefix}." if prefix else ""
        local = {k[len(pre):]: v for k, v in axes.items() if k.startswith(pre)}
        split |= {pre + k for k in take(mesh, local)}
    gathered: dict[str, list[str]] = {}
    with torch.no_grad():
        for name, axis in axes.items():
            owner_name, _, leaf = name.rpartition(".")
            owner = model.get_submodule(owner_name)
            p = owner._parameters[leaf]
            shard = torch.nn.Parameter(_slice(mesh, p.detach(), axis).clone(),
                                       requires_grad=p.requires_grad)
            shard.model_axis, shard.model_mesh, shard.full_shape = axis, mesh, tuple(p.shape)
            owner._parameters[leaf] = shard
            if name not in split:
                gathered.setdefault(owner_name, []).append(leaf)
    for owner_name, leaves in gathered.items():
        _gather_hooks(model.get_submodule(owner_name), leaves)
    model._model_sharded = True
    return model


def model_grad_sums(model: torch.nn.Module) -> None:
    """Sum over the model group the gradients of the replicated leaves a
    split product uses by slices (the conformer's feed-forward `b1`), in
    place: one bucketed all-reduce."""
    grads, mesh = [], None
    for p in model.parameters():
        m = getattr(p, "model_grad_sum", None)
        if m is not None and p.grad is not None:
            grads.append(p.grad)
            mesh = m
    if grads:
        all_reduce_tensors_(mesh, grads, "model")


def squared_norms(tensors: list[torch.Tensor], params=None) -> list[torch.Tensor]:
    """Each tensor's squared 2-norm (float32, 0-d), a sharded parameter's
    (where `params` names the tensors' parameters) summed over its model
    group: one all-reduce for all of them."""
    sq = [torch.sum(torch.square(t.float())) for t in tensors]
    if params is None:
        return sq
    idx = [i for i, p in enumerate(params) if model_axis(p) is not None]
    if idx:
        mesh = params[idx[0]].model_mesh
        summed = all_reduce_(mesh, torch.stack([sq[i] for i in idx]), "model")
        for j, i in enumerate(idx):
            sq[i] = summed[j]
    return sq


def gathered_state_dict(model: torch.nn.Module) -> dict[str, torch.Tensor]:
    """`model.state_dict()` with every sharded leaf gathered whole under its
    unsharded key (a collective: every rank of the model group calls it)."""
    out = dict(model.state_dict())
    for name, p in model.named_parameters():
        if model_axis(p) is not None:
            out[name] = gather_leaf_value(p, p.detach())
    return out


def load_gathered_state_dict(model: torch.nn.Module, state: dict) -> None:
    """Load whole tensors (`gathered_state_dict`, a checkpoint or
    `convert.params_from_jax`) into `model`, sharded or not: each sharded
    leaf takes this rank's block."""
    params = dict(model.named_parameters())
    local = {k: shard_of(params[k], v) if k in params else v for k, v in state.items()}
    model.load_state_dict(local)
