"""The chain (LF-MMI) objective in plain PyTorch, float32, its gradient by
autograd (Kaldi's chain-training.cc semantics):

    objf = sum_b (log p_num(b) - log Z_den(b))
    loss = -(objf - 0.5 l2 ||y||^2 - oor sum relu(|y| - 30)^2
             + xent_regularize * sum gamma_num . log_softmax(x)) / (B T)

The denominator is the HMM's forward pass with the leaky-HMM (before the
first frame and after each, alpha += leaky * init * sum(alpha)), every
state final with weight one; the numerator the forward pass over each
chunk's lattice times the HMM started from the initial probabilities.  The
denominator runs in probability space, renormalised every frame, with each
(row, frame)'s largest output taken out of the emissions and added back to
the log (the leak keeps every state's mass above a floor); the numerator
in the log semiring.
gamma_num (the occupancies, the xent target) is the numerator's gradient,
a constant of the loss.
"""

from __future__ import annotations

import numpy as np
import torch

from chainbench.reference.lattice import Product


def initial_probs(num_states: int, src, dst, logw, iters: int = 100,
                  start_boost: float = 0.01) -> np.ndarray:
    """Kaldi's DenominatorGraph::SetInitialProbs: x <- normalize(x M) from
    uniform, `iters` times, in float64; then `start_boost` of the mass moved
    onto the start state, which the stationary distribution leaves empty
    (the utterance-initial chunks would have no numerator otherwise)."""
    prob = np.exp(np.asarray(logw, dtype=np.float64))
    x = np.full(num_states, 1.0 / num_states)
    for _ in range(iters):
        y = np.zeros(num_states)
        np.add.at(y, dst, x[src] * prob)
        x = y / y.sum()
    x = (1.0 - start_boost) * x
    x[0] += start_boost
    return x.astype(np.float32)


class DenGraph:
    """The HMM's arcs and initial probabilities on `device`."""

    def __init__(self, num_states, src, dst, pdf, logw, init, device):
        self.S = int(num_states)
        self.src = torch.as_tensor(np.asarray(src), dtype=torch.long, device=device)
        self.dst = torch.as_tensor(np.asarray(dst), dtype=torch.long, device=device)
        self.pdf = torch.as_tensor(np.asarray(pdf), dtype=torch.long, device=device)
        self.w = torch.exp(torch.as_tensor(np.asarray(logw), dtype=torch.float32, device=device))
        self.init = torch.as_tensor(init, dtype=torch.float32, device=device)


def den_logz(y: torch.Tensor, den: DenGraph, leaky: float) -> torch.Tensor:
    """log Z [B] of y [B, T, P]."""
    B, T, _ = y.shape
    m = y.detach().amax(-1)
    p = torch.exp(y - m[..., None])
    alpha = den.init.expand(B, den.S)
    logz = m.sum(1) + float(np.log1p(leaky))
    for t in range(T):
        vals = alpha[:, den.src] * den.w * p[:, t, den.pdf]
        nxt = torch.zeros(B, den.S, device=y.device).index_add(1, den.dst, vals)
        nxt = nxt + leaky * den.init * nxt.sum(1, keepdim=True)
        c = nxt.sum(1, keepdim=True)
        alpha = nxt / c
        logz = logz + torch.log(c[:, 0])
    return logz


class NumGraph:
    """A batch's `Product` on `device`."""

    def __init__(self, prod: Product, den: DenGraph, device):
        def t(a):
            return torch.as_tensor(a, dtype=torch.long, device=device)

        self.B = prod.num_states
        self.rows = [t(r) for r in prod.rows]
        self.pairs = [t(p) for p in prod.pairs]
        self.final, self.final_rows = t(prod.final), t(prod.final_rows)
        self.den = den


def _log_index_add(n: int, idx: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """log sum exp of `vals` by `idx` into n slots (-inf where none lands)."""
    m = torch.full((n,), -torch.inf, device=vals.device).scatter_reduce(
        0, idx, vals.detach(), "amax", include_self=False)
    m = torch.where(torch.isfinite(m), m, 0.0)
    s = torch.zeros(n, device=vals.device).index_add(0, idx, torch.exp(vals - m[idx]))
    # log 0 = -inf for the slots nothing reaches, with no gradient through it
    reached = s > 0
    return torch.where(reached, torch.log(torch.where(reached, s, 1.0)) + m, -torch.inf)


def num_logp(y: torch.Tensor, num: NumGraph) -> torch.Tensor:
    """log p [B] of y [B, T, P] under each row's lattice times the HMM, in
    the log semiring (a row's lattice may allow only pdfs far below the
    frame's best)."""
    B, T, _ = y.shape
    S = num.den.S
    logw = torch.log(num.den.w)
    alpha = torch.log(num.den.init).expand(len(num.rows[0]), S).reshape(-1)
    for t in range(T):
        j, s, j1, s1, k, row, pdf = num.pairs[t]
        vals = alpha[j * S + s] + logw[k] + y[row, t, pdf]
        alpha = _log_index_add(len(num.rows[t + 1]) * S, j1 * S + s1, vals)
    end = alpha.view(-1, S)[num.final]
    rows = num.final_rows[:, None].expand(-1, S).reshape(-1)
    return _log_index_add(B, rows, end.reshape(-1))


def chain_loss(y: torch.Tensor, x: torch.Tensor, den: DenGraph, num: NumGraph,
               opts: dict) -> torch.Tensor:
    """The loss to minimise (module doc) for chain outputs y and xent logits
    x, both [B, T, P] float32; `opts`: l2_regularize,
    leaky_hmm_coefficient, xent_regularize, out_of_range_regularize,
    out_of_range_limit."""
    B, T, _ = y.shape
    lp_num = num_logp(y, num)
    gamma = torch.autograd.grad(lp_num.sum(), y, retain_graph=True)[0].detach()
    objf = (lp_num - den_logz(y, den, opts["leaky_hmm_coefficient"])).sum()
    l2 = -0.5 * opts["l2_regularize"] * torch.sum(y * y)
    oor = torch.clamp(torch.abs(y) - opts["out_of_range_limit"], min=0.0)
    oor_term = -opts["out_of_range_regularize"] * torch.sum(oor * oor)
    xent = torch.sum(gamma * torch.log_softmax(x, dim=-1))
    total = objf + l2 + oor_term + opts["xent_regularize"] * xent
    return -total / (B * T)
