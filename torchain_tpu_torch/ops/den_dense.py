"""Denominator forward-backward on the dense Moore graph, as a loop of
matrix products.

Behavioral reference: kaldi/src/chain/chain-denominator.{h,cc}
(probability space, per-frame "arbitrary scale" renormalization, leaky
HMM).  Port of torchain_tpu/ops/den_dense.py: the graph is state-split into
a Moore machine (graphs/den_graph.py `make_dense_den_graph`) so that one
frame of the alpha recursion is

    sigma   = alpha @ E_mat            [B,E] @ [E,S]  (segment sum, one-hot)
    sigma'  = sigma + leaky * (sum sigma) * init      (rank-1 leak)
    h       = sigma' @ V               [B,S] @ [S,E]  (transition mass)
    alpha'  = h * (p_t @ P_mat)        emission as a diagonal scale
    alpha'  = alpha' / sum(alpha')     per-frame renormalization, the log
                                       of the scale accumulated

Probabilities are conditioned by subtracting the per-frame max of y before
exponentiation (added back to log Z).  The backward pass mirrors it
transposed and emits the pdf occupancies gamma = d(log Z)/dy directly.

The products are outside any kernel in the JAX package (XLA's), so here
they are `torch.matmul` in float32 (the caller keeps TF32 off).  This is
the library form that the fused kernels of ops/den_pallas.py are timed
against, and whose values they must match.
"""

from __future__ import annotations

import math

import torch

from torchain_tpu_torch.ops.device_graphs import DeviceDenseDenGraph


def leak(sigma: torch.Tensor, init: torch.Tensor, leaky: float) -> torch.Tensor:
    """L sigma = sigma + leaky * sum(sigma) * init, rows of [B, S]."""
    if leaky <= 0.0:
        return sigma
    return sigma + leaky * sigma.sum(-1, keepdim=True) * init


def leak_t(v: torch.Tensor, init: torch.Tensor, leaky: float) -> torch.Tensor:
    """L^T v = v + leaky * (init . v) * ones, rows of [B, S]."""
    if leaky <= 0.0:
        return v
    return v + leaky * (v * init).sum(-1, keepdim=True)


def den_forward(
    y: torch.Tensor,  # [B, T, P]
    g: DeviceDenseDenGraph,
    leaky: float = 0.0,
) -> tuple[torch.Tensor, dict]:
    """Returns (log_z [B], residuals for the backward pass)."""
    y = y.detach().float()
    B, T, _ = y.shape
    ymax = y.max(-1).values  # [B, T]
    p = torch.exp(y - ymax[..., None])  # [B, T, P], in (0, 1]
    sigma = g.init_orig.expand(B, g.num_orig)
    logc = y.new_empty((T, B))
    sigma_hats = y.new_empty((T, B, g.num_orig))
    for t in range(T):
        sigma_hats[t] = sigma  # the carry at entry of the frame
        h = leak(sigma, g.init_orig, leaky) @ g.V  # [B, E]
        alpha = h * (p[:, t] @ g.P_mat)
        c = alpha.sum(-1, keepdim=True)
        logc[t] = torch.log(c[:, 0])
        sigma = (alpha / c) @ g.E_mat  # [B, S]
    log_z = logc.sum(0) + ymax.sum(-1)
    if leaky > 0.0:
        log_z = log_z + math.log1p(leaky)
    res = dict(p=p, ymax=ymax, logc=logc, sigma_hats=sigma_hats, log_z=log_z)
    return log_z, res


def den_backward(g: DeviceDenseDenGraph, res: dict, leaky: float = 0.0) -> torch.Tensor:
    """Returns gamma [B, T, P] = d(log Z)/dy.

    Scale bookkeeping: with alpha~_t(e) the true (unscaled) forward value,
    the forward stored sigma_hat_{t-1} (normalized), so

        alpha~_t = ah_t * exp(F_{t-1} + ymax_t),
        ah_t     = pe_t * ((L sigma_hat_{t-1}) @ V),
        F_t      = sum_{tau<=t} (log c_tau + ymax_tau).

    The backward carry is normalized bh_t with true beta~_t = bh_t *
    exp(G_t), G_T = log1p(leaky).  Then

        gamma_t = P_mat_scatter(ah_t * bh_t) * exp(F_{t-1} + ymax_t + G_t
                                                   - log Z),

    whose exponent is always O(1): no overflow."""
    p, ymax, logc = res["p"], res["ymax"], res["logc"]
    sigma_hats, log_z = res["sigma_hats"], res["log_z"]
    B, T, P = p.shape
    init = g.init_orig
    F = torch.cumsum(logc + ymax.T, 0)  # [T, B]
    F_prev = torch.cat([F.new_zeros((1, B)), F[:-1]])
    bh = p.new_ones((B, g.num_exp))
    G = p.new_full((B,), math.log1p(leaky) if leaky > 0.0 else 0.0)
    gamma = p.new_empty((B, T, P))
    for t in range(T - 1, -1, -1):
        pe = p[:, t] @ g.P_mat  # [B, E]
        ah = pe * (leak(sigma_hats[t], init, leaky) @ g.V)
        scale = torch.exp(F_prev[t] + ymax[:, t] + G - log_z)  # [B]
        gamma[:, t] = ((ah * bh) @ g.P_mat.T) * scale[:, None]
        # pull beta back one frame, over expanded states
        v = leak_t((pe * bh) @ g.V.T, init, leaky)  # [B, S]
        nb = v @ g.E_mat.T  # [B, E] (original -> expanded broadcast)
        d = nb.max(-1, keepdim=True).values
        d = torch.where(d > 0, d, torch.ones_like(d))
        bh = nb / d
        G = G + ymax[:, t] + torch.log(d[:, 0])
    return gamma
