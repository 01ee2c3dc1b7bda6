"""The reference's first training steps: from the initial parameters, one
step per batch (forward, chain loss, backward, the optimizer chain), and
the readings the comparison takes (chainbench/check.py): each step's loss, the first
step's gradient as the optimizer gets it (after the clip), each
parameter's change over the steps, and the constrained parameters just
before and after the first semi-orthogonal constraint.

`fault` puts a known error in the reference, for the checks that the
comparison catches it: "half" takes each batch's first half of rows only
(the mean over them), "unchanged" leaves the parameters as they were,
"double" moves the first parameter by twice its update (an answer altered
where it is produced), "unconstrained" leaves the semi-orthogonal
constraint out (chainbench/reference/optim.py).
"""

from __future__ import annotations

import importlib

import torch

from chainbench.reference.chain import DenGraph, NumGraph, chain_loss
from chainbench.reference.lattice import product
from chainbench.reference.ops import Products
from chainbench.reference.optim import Chain


def trunk(name: str):
    """The reference trunk `chainbench/reference/<name>.py`: its `forward`,
    and `constrained(names)`, the parameters the semi-orthogonal constraint
    acts on (none where the module has no such function)."""
    return importlib.import_module(f"chainbench.reference.{name}")


def run_steps(params0: dict, batches: list, den: DenGraph, model: str, model_cfg: dict,
              loss_opts: dict, recipe: dict, precision: str = "float32",
              fault: str | None = None) -> dict:
    """`batches`: (feats [B, T_in, F] on the device, the rows' lattices) per
    step.  Returns dict(loss=[...], grad1_vec={name: the first step's
    gradient}, change_vec={name: the change over the steps}) and, where the
    steps reach a constraint, ortho_in and ortho_out={name: the constrained
    parameter just before and after the first one})."""
    mod = trunk(model)
    forward = mod.forward
    mm = Products(precision)
    names = list(params0)
    params = [params0[n].detach().clone().requires_grad_(True) for n in names]
    constrained = getattr(mod, "constrained", lambda _names: [])(names)
    opt = Chain(params, names, recipe, constrained, None if fault == "half" else fault)
    losses, grad1_vec = [], None
    for feats, lattices in batches:
        if fault == "half":
            feats, lattices = feats[:feats.shape[0] // 2], lattices[:len(lattices) // 2]
        prod = product(lattices, den.src.cpu().numpy(), den.dst.cpu().numpy(),
                       den.pdf.cpu().numpy())
        num = NumGraph(prod, den, feats.device)
        y, x = forward(dict(zip(names, params)), feats, model_cfg, mm)
        loss = chain_loss(y, x, den, num, loss_opts)
        grads = torch.autograd.grad(loss, params)
        used = opt.step(list(grads))
        if grad1_vec is None:
            grad1_vec = {n: g.detach().clone() for n, g in zip(names, used)}
        losses.append(float(loss.detach()))
        del y, x, loss, grads, num
    with torch.no_grad():
        change_vec = {n: p - params0[n] for n, p in zip(names, params)}
    out = dict(loss=losses, grad1_vec=grad1_vec, change_vec=change_vec)
    if opt.first_constraint is not None:
        out.update(ortho_in=opt.first_constraint["before"],
                   ortho_out=opt.first_constraint["after"])
    return out
