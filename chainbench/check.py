"""The comparison that decides `correct`: the program's first training
steps, as the window's own call and feed took them, against the
reference's from the same parameters on the same rows.

Numbers (a cell's limits, `chainbench/limits/<workload>.json`, name the
ones compared; the others are reported):

  loss<k>        the relative gap of step k's loss, k = 1..n (step 1 reads
                 the forward's precision alone; later steps also Adam's
                 amplification of the first updates' round-off)
  grad1_leaf     the worst parameter's gap between the norms of the first
                 step's gradient as the optimizer gets it (the program's
                 worked out from Adam's first moment after one step,
                 m / (1 - b1)), over the larger of the reference's norm of
                 that parameter and of the median parameter
  grad1_diff     the same of the norm of the two gradients' difference: a
                 precision's round-off is a random error, nearly orthogonal
                 to the gradient, which moves its norm only at second order
  grad1_diff_med the median parameter's norm of that difference over its own
                 norm (steady where the worst parameter is one whose true
                 gradient nearly cancels, as a bias that batchnorms
                 downstream all but remove)
  grad1_diff_min the least disturbed parameter's (in a deep bf16 trunk the
                 others' round-off grows with depth past what a lower
                 precision adds: there only this one tells them apart)
  change_leaf    the worst parameter's gap between the norms of its change
                 over the n steps, over the larger of its own and the
                 median's, counting only the entries whose reference first
                 gradient is at least a thousandth of the median
                 parameter's root-mean-square entry: the others (a key's
                 bias under softmax, a bias under batchnorm) are nought to
                 rounding and move under Adam by round-off alone
  ortho_step     the first semi-orthogonal constraint, followed from the
                 program's own state: Kaldi's constraint step
                 (chainbench/reference/optim.py) applied to the program's
                 constrained parameters as they were just before it, against
                 what the program made of them; the worst parameter's norm
                 of the difference over the norm of the reference's step
                 (1 where the constraint is left out, 0.5 where it moves
                 half as far).  The steps before it are compared by the
                 numbers above, from the same start as the reference's.
                 Infinite where the reference reached a constraint and the
                 program did not

A reading that is not a finite number fails its limit.
"""

from __future__ import annotations

import math
import statistics

import torch

from chainbench.reference.optim import constrain_kernel

#: an entry whose first gradient is under this share of the median
#: parameter's root-mean-square entry is left out of the change
STILL = 1e-3


def _norm(t) -> float:
    return float(torch.linalg.vector_norm(t))


def worst_leaf(gap: dict, ref: dict) -> tuple:
    """(the largest gap[n] / max(ref[n], the median ref), its parameter)."""
    med = statistics.median(ref[n] for n in gap)
    return max((gap[n] / max(ref[n], med, 1e-30), n) for n in gap)


def numbers(prog: dict, ref: dict, where: bool = False) -> dict:
    """`prog`, `ref`: dict(loss=[...], grad1_vec={name: the first gradient},
    change_vec={name: the change over the steps}).  With `where`, also the
    parameter each worst-leaf number was read at (`<number>_at`)."""
    out = {f"loss{k}": abs(a - b) / max(abs(b), 1e-30)
           for k, (a, b) in enumerate(zip(prog["loss"], ref["loss"]), 1)}
    g = ref["grad1_vec"]
    dev = next(iter(g.values())).device
    gp = {n: prog["grad1_vec"][n].to(dev) for n in g}
    norm = {n: _norm(v) for n, v in g.items()}
    diff = {n: _norm(gp[n] - g[n]) for n in g}
    floor = STILL * statistics.median(norm[n] / math.sqrt(g[n].numel()) for n in g)
    moving = {n: g[n].abs() >= floor for n in g}
    dp = {n: _norm(prog["change_vec"][n].to(dev)[m]) for n, m in moving.items() if m.any()}
    dr = {n: _norm(ref["change_vec"][n][moving[n]]) for n in dp}
    leaf = dict(
        grad1_leaf=worst_leaf({n: abs(_norm(gp[n]) - norm[n]) for n in g}, norm),
        grad1_diff=worst_leaf(diff, norm),
        change_leaf=worst_leaf({n: abs(dp[n] - dr[n]) for n in dp}, dr))
    for name, (value, at) in leaf.items():
        out[name] = value
        if where:
            out[f"{name}_at"] = at
    rel = [diff[n] / max(norm[n], 1e-30) for n in g]
    out["grad1_diff_med"] = statistics.median(rel)
    out["grad1_diff_min"] = min(rel)
    if "ortho_in" in ref:
        out["ortho_step"] = ortho_step(prog, dev)
    return out


def ortho_step(prog: dict, dev) -> float:
    """The worst constrained parameter's ||after - K(before)|| / ||K(before)
    - before||, K the reference's constraint in float32, TF32 off."""
    if "ortho_in" not in prog:
        return math.inf
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        worst = 0.0
        for n, before in prog["ortho_in"].items():
            before = before.to(dev).float()
            want = constrain_kernel(before)
            gap = _norm(prog["ortho_out"][n].to(dev).float() - want)
            worst = max(worst, gap / max(_norm(want - before), 1e-30))
        return worst
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def verdict(values: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}) over the numbers the limits
    name (the others are not compared); False without limits, or where a
    named number is missing."""
    out, ok = {}, bool(limits)
    for name, lim in limits.items():
        v = values.get(name, math.nan)
        out[name] = dict(value=v, limit=lim)
        if not (math.isfinite(v) and v <= lim):
            ok = False
    return ok, out
