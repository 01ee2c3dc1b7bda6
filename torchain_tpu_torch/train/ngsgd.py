"""Online natural-gradient preconditioning, Kaldi's NG-SGD role (torch),
port of torchain_tpu/train/ngsgd.py.

Kaldi's `OnlineNaturalGradient` (nnet3/natural-gradient-online.{h,cc};
Povey, Zhang & Khudanpur 2015) preconditions each affine layer's gradient
on both sides by a damped online estimate of that side's Fisher factor,

    G' = (F_out + b_out I)^-1  G  (F_in + b_in I)^-1 ,

with the damping alpha * tr(F) / dim (alpha = 4), and rescales the result
to the raw gradient's Frobenius norm: the step size is left to the learning
rate.  As in the JAX package, each side keeps a full covariance as an
exponential moving average of the scatter matrix and its exact damped
inverse (`torch.linalg.solve`), refreshed every `inverse_period` updates.
A kernel [..., in, out] is viewed as the matrix [rf*in, out] (the port's
parameters keep flax's layout, so this is the same view); sides wider than
`max_dim` pass through, and 1-D parameters pass through whole.

`NGSGD` is the JAX chain natural_gradient() -> sgd(lr, momentum) as one
`torch.optim.Optimizer` (a `torch.optim.SGD` whose step preconditions the
gradients first).  Its `state_dict` carries each side's covariance and
inverse, the momentum buffers and the count: the checkpoint format of
`train.chain_tx.ChainOptimizer`, which computes the same update on the
device (`precondition_`) with the clip before it and max-change after it.

A leaf sharded over the model axis (`parallel.shard_params`) is
preconditioned whole, as the JAX function sees it: its gradient is
gathered over the model group, preconditioned, and this rank's block kept;
its covariances have the whole leaf's sides.
"""

from __future__ import annotations

import dataclasses

import torch

from torchain_tpu_torch.parallel.sharding import full_shape, gather_leaf_value, shard_of


@dataclasses.dataclass(frozen=True)
class NGOptions:
    #: damping: F_damped = F + alpha * (tr(F)/D) * I  (Kaldi's alpha)
    alpha: float = 4.0
    #: EMA forgetting factor of the Fisher estimate
    ema: float = 0.95
    #: recompute the damped inverses every N optimizer steps
    inverse_period: int = 4
    #: sides with dim > max_dim pass through un-preconditioned
    max_dim: int = 1024


def _as_matrix(g: torch.Tensor) -> torch.Tensor:
    """An N-D kernel [..., in, out] as the matrix [rf * in, out]."""
    return g.reshape(-1, g.shape[-1])


def _eligible(shape, max_dim: int):
    """(row_dim | None, col_dim | None) for a parameter shape."""
    if len(shape) < 2 or min(shape) < 2:
        return None, None
    rows = 1
    for s in shape[:-1]:
        rows *= s
    cols = shape[-1]
    return (rows if rows <= max_dim else None), (cols if cols <= max_dim else None)


def _damped_inverse(cov: torch.Tensor, alpha: float, check_errors: bool = True) -> torch.Tensor:
    d = cov.shape[0]
    eye = torch.eye(d, dtype=cov.dtype, device=cov.device)
    damp = alpha * (torch.trace(cov) / d) + 1e-30
    if check_errors:
        return torch.linalg.solve(cov + damp * eye, eye)
    # the same solve without the check that reads its status on the host
    return torch.linalg.solve_ex(cov + damp * eye, eye)[0]


def _precondition(g, state: dict, refresh: bool, opts: NGOptions, in_place: bool):
    if "row_cov" not in state and "col_cov" not in state:
        return g
    m = _as_matrix(g).float()
    r, c = m.shape
    out = m
    for side, scatter in (("row", lambda: (m @ m.T) / c), ("col", lambda: (m.T @ m) / r)):
        if f"{side}_cov" not in state:
            continue
        cov = opts.ema * state[f"{side}_cov"] + (1.0 - opts.ema) * scatter()
        if refresh:
            inv = _damped_inverse(cov, opts.alpha, check_errors=not in_place)
        if in_place:
            state[f"{side}_cov"].copy_(cov)
            if refresh:
                state[f"{side}_inv"].copy_(inv)
        else:
            state[f"{side}_cov"] = cov
            if refresh:
                state[f"{side}_inv"] = inv
        inv = state[f"{side}_inv"]
        out = inv @ out if side == "row" else out @ inv
    # Kaldi: keep the raw gradient's Frobenius norm
    nrm_in = torch.sqrt(torch.sum(m * m))
    nrm_out = torch.sqrt(torch.sum(out * out))
    out = out * (nrm_in / torch.clamp(nrm_out, min=1e-30))
    return out.reshape(g.shape).to(g.dtype)


def precondition(g: torch.Tensor, state: dict, count: int, opts: NGOptions) -> torch.Tensor:
    """One natural-gradient update of one parameter's gradient: updates the
    sides in `state` ("row_cov", "row_inv", "col_cov", "col_inv", those that
    exist) and returns the preconditioned gradient in g's dtype and shape.
    `count` is the count after this update."""
    return _precondition(g, state, count % opts.inverse_period == 0, opts, in_place=False)


def precondition_(g: torch.Tensor, state: dict, refresh: bool, opts: NGOptions) -> torch.Tensor:
    """`precondition` writing the sides into `state`'s tensors in place,
    with no read on the host (the Trainer's chain's form, train/chain_tx.py):
    `refresh` (known on the host from the count) says whether this update
    recomputes the inverses, and the solve skips torch's error check, which
    reads its status on the host.  The same bits as `precondition`."""
    return _precondition(g, state, refresh, opts, in_place=True)


class NGSGD(torch.optim.SGD):
    """natural_gradient(opts) -> sgd(lr, momentum): each step replaces every
    gradient by its preconditioned form, then takes torch's momentum SGD
    step (optax's trace: t = g + momentum * t, p -= lr * t)."""

    def __init__(self, params, lr=1e-3, momentum=0.9, opts: NGOptions = NGOptions()):
        super().__init__(params, lr=lr, momentum=momentum)
        self.opts = opts
        for group in self.param_groups:
            group["ng_count"] = 0
            for p in group["params"]:
                row, col = _eligible(full_shape(p), opts.max_dim)
                for side, d in (("row", row), ("col", col)):
                    if d is not None:
                        eye = torch.eye(d, dtype=torch.float32, device=p.device)
                        self.state[p][f"{side}_cov"] = eye
                        self.state[p][f"{side}_inv"] = eye.clone()

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            group["ng_count"] += 1
            for p in group["params"]:
                if p.grad is not None:
                    g = precondition(gather_leaf_value(p, p.grad), self.state[p],
                                     group["ng_count"], self.opts)
                    p.grad.copy_(shard_of(p, g))
        return super().step(closure)

    def state_bytes(self) -> int:
        """The bytes of the covariances, inverses and momentum buffers."""
        return sum(t.numel() * t.element_size() for st in self.state.values()
                   for t in st.values() if isinstance(t, torch.Tensor))
