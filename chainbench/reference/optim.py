"""The training recipe's optimizer chain in plain PyTorch, float32 (optax's
chain as Kaldi recipes configure it), around an update rule found by the
recipe's `optimizer` name (`chainbench/reference/optimizers/<name>.py`):

    g <- g * min(1, clip / ||g||)                     (global norm)
    d <- rule(g)                                      (Adam: m / (sqrt(v) + eps), bias-corrected)
    u <- -lr(c - 1) * d                               (c: updates so far, this one counted)
    u <- u * min(1, max_change / ||u_leaf||)          (each parameter)
    u <- u * min(1, max_param_change / ||u||)         (all of them)
    p <- p + u
    every `semi_ortho_every` updates: the semi-orthogonal constraint on
    the trunk's factored bottlenecks (`constrain`)

lr(n) = lr * (lr_final / lr)^(n / decay_steps), held at lr_final (Kaldi's
exponential schedule; lr at n = 0).
"""

from __future__ import annotations

import importlib
import math

import torch


def learning_rate(recipe: dict, count: int) -> float:
    lr = recipe["lr"]
    final, steps = recipe.get("lr_final", 0.0), recipe.get("lr_decay_steps", 0)
    if not (final > 0 and steps > 0) or count <= 0:
        return lr
    value = lr * (final / lr) ** (count / steps)
    return max(value, final) if final < lr else min(value, final)


def constrain(M: torch.Tensor) -> torch.Tensor:
    """One step of Kaldi's ConstrainOrthonormal (nnet-utils.cc) with a
    floating scale, on M [rows, cols] with rows <= cols (the transpose is
    constrained otherwise): P = M M^T, scale^2 = tr(P P) / tr(P), and

        M <- M - 4 speed / scale^2 (P - scale^2 I) M

    with speed 1/8, halved where tr(P P) rows / tr(P)^2 > 1.02 and halved
    again where it is over 1.1."""
    if M.shape[0] > M.shape[1]:
        return constrain(M.T).T
    M = M.float()
    P = M @ M.T
    trace_p, trace_pp = torch.trace(P), torch.sum(P * P)
    scale2 = trace_pp / trace_p
    ratio = float(trace_pp * P.shape[0] / (trace_p * trace_p))
    speed = 0.125
    if ratio > 1.02:
        speed *= 0.5
        if ratio > 1.1:
            speed *= 0.5
    Q = P - scale2 * torch.eye(P.shape[0], device=M.device)
    return M - (4.0 * speed / scale2) * (Q @ M)


def constrain_kernel(kernel: torch.Tensor) -> torch.Tensor:
    """The constraint on a tap kernel [taps, in, out] as the linear map
    from the spliced input (taps * in) to the bottleneck (out): Kaldi's
    linear component over Append(-stride, 0)."""
    return constrain(kernel.reshape(-1, kernel.shape[-1])).reshape(kernel.shape)


class Chain:
    """The chain over a list of named parameter tensors; `step(grads)`
    returns the clipped gradient it used.  `constrained` names the
    parameters the semi-orthogonal constraint acts on; `first_constraint`
    holds them just before and just after its first application.  `fault`
    plants an error for the checks: "unchanged" applies no update (nor the
    constraint), "double" doubles the first parameter's update,
    "unconstrained" leaves the constraint out."""

    def __init__(self, params: list, names: list, recipe: dict, constrained=(),
                 fault: str | None = None):
        self.params, self.names, self.recipe, self.fault = params, names, recipe, fault
        self.constrained = [i for i, n in enumerate(names) if n in set(constrained)]
        rule = importlib.import_module(f"chainbench.reference.optimizers.{recipe['optimizer']}")
        self.rule = rule.Rule(params, recipe)
        self.count = 0
        self.first_constraint = None

    @torch.no_grad()
    def step(self, grads: list) -> list:
        r = self.recipe
        norm = math.sqrt(sum(float(torch.sum(g * g)) for g in grads))
        if r["grad_clip"] > 0 and norm > r["grad_clip"]:
            grads = [g * (r["grad_clip"] / norm) for g in grads]
        lr = learning_rate(r, self.count)
        self.count += 1
        ups = [-lr * d for d in self.rule.direction(grads, self.count)]
        if r.get("max_change_per_component", 0) > 0:
            mc = r["max_change_per_component"]
            ups = [u * min(1.0, mc / max(float(torch.linalg.vector_norm(u)), 1e-30))
                   for u in ups]
        if r.get("max_param_change", 0) > 0:
            total = math.sqrt(sum(float(torch.sum(u * u)) for u in ups))
            ups = [u * min(1.0, r["max_param_change"] / max(total, 1e-30)) for u in ups]
        if self.fault == "double":
            ups[0] = 2 * ups[0]
        if self.fault != "unchanged":
            for p, u in zip(self.params, ups):
                p.add_(u)
        every = r.get("semi_ortho_every", 0)
        if every and self.count % every == 0 and self.constrained:
            self._constrain()
        return grads

    def _constrain(self) -> None:
        before = {self.names[i]: self.params[i].detach().clone() for i in self.constrained}
        if self.fault not in ("unchanged", "unconstrained"):
            for i in self.constrained:
                self.params[i].copy_(constrain_kernel(self.params[i]))
        if self.first_constraint is None:
            self.first_constraint = dict(
                before=before,
                after={self.names[i]: self.params[i].detach().clone() for i in self.constrained})
