"""Denominator forward-backward in the log semiring over sparse arcs.

Behavioral reference: kaldi/src/chain/chain-denominator.cc
(`DenominatorComputation::Forward/Backward`) and the per-arc kernels of
chain-kernels.cu, re-expressed in the LOG semiring (the same objective as
Kaldi's probability space with renormalization, conditioned another way).
Port of torchain_tpu/ops/den_scan.py (`den_forward`, `den_backward`): the
general form, for any arc structure, and the exactness reference of the
dense and slot-dense recursions.  It is plain PyTorch (`index_select`,
`scatter_reduce_`, `index_add_`) with one loop iteration per frame; the JAX
package has no kernel for it either.  Its alpha-checkpointed variant
(`den_forward_checkpointed`, `den_backward_checkpointed`) stores alpha every
`every` frames and recomputes each segment's alphas before its beta sweep:
an `every`-fold cut of the [T+1, B, S] residual for one more forward pass.
ops/chain_loss.py takes it where the graph's `checkpoint_every` is set
(the JAX package reads TORCHAIN_ALPHA_CHECKPOINT instead).

Gradients are not taken through the loop: d(log Z)/dy[t, j] = gamma[t, j],
so the backward pass IS the beta recursion, wired up in ops/chain_loss.py.
"""

from __future__ import annotations

import math

import torch

from torchain_tpu_torch.ops.device_graphs import DeviceDenGraph

NEG_INF = float("-inf")


def _seg_logsumexp(vals: torch.Tensor, seg: torch.Tensor, num_seg: int) -> torch.Tensor:
    """Segment logsumexp along axis 0.  vals [A, B], seg [A] -> [num_seg, B];
    an empty segment, or one whose values are all -inf, gives -inf."""
    A, B = vals.shape
    idx = seg[:, None].expand(A, B)
    m = vals.new_full((num_seg, B), NEG_INF).scatter_reduce_(
        0, idx, vals, "amax", include_self=True
    )
    m_safe = torch.where(torch.isfinite(m), m, 0.0)
    s = vals.new_zeros((num_seg, B)).index_add_(0, seg, torch.exp(vals - m_safe[seg]))
    return torch.where(s > 0, torch.log(s) + m_safe, NEG_INF)


def _leak(log_alpha: torch.Tensor, log_init: torch.Tensor, leaky: float) -> torch.Tensor:
    """alpha' = alpha + leaky * init * sum(alpha)   (log space, [B, S])."""
    if leaky <= 0.0:
        return log_alpha
    tot = torch.logsumexp(log_alpha, dim=-1, keepdim=True)
    return torch.logaddexp(log_alpha, math.log(leaky) + log_init + tot)


def _fwd_step(alpha: torch.Tensor, y_t: torch.Tensor, g: DeviceDenGraph,
              leaky: float) -> torch.Tensor:
    """alpha'_{t+1} [B, S] from alpha'_t and y_t [B, P]."""
    # arc values [A, B]: alpha'[src] + w + y_t[pdf]
    arc = alpha[:, g.in_src].T + g.in_logw[:, None] + y_t[:, g.in_pdf].T
    return _leak(_seg_logsumexp(arc, g.in_dst, g.num_states).T, g.log_init, leaky)


def _bwd_step(b: torch.Tensor, y_t: torch.Tensor, alpha_prev: torch.Tensor,
              g: DeviceDenGraph, log_z: torch.Tensor, leaky: float):
    """(b_{t-1} [B, S], gamma_t [B, P]) from b = log dZ/dalpha'_t, y_t and
    alpha_prev = alphas[t]."""
    if leaky > 0.0:
        tot = torch.logsumexp(g.log_init + b, dim=-1, keepdim=True)
        b = torch.logaddexp(b, math.log(leaky) + tot)
    # one pass over the src-sorted arcs: arc_w feeds both the beta
    # pull-back and, combined with alpha, the gamma accumulation
    arc_w = g.out_logw[:, None] + y_t[:, g.out_pdf].T + b[:, g.out_dst].T
    arc_post = alpha_prev[:, g.out_src].T + arc_w
    P = y_t.shape[1]
    gamma_t = y_t.new_zeros((P, b.shape[0])).index_add_(
        0, g.out_pdf, torch.exp(arc_post - log_z)
    ).T
    return _seg_logsumexp(arc_w, g.out_src, g.num_states).T, gamma_t


def den_forward(
    y: torch.Tensor,  # [B, T, P] nnet log-prob outputs
    g: DeviceDenGraph,
    leaky: float = 0.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (log_z [B], alphas [T+1, B, S]) where alphas are post-leak."""
    y = y.detach().float()
    B, T, _ = y.shape
    alpha = _leak(g.log_init.expand(B, g.num_states), g.log_init, leaky)
    alphas = [alpha]
    for t in range(T):
        alpha = _fwd_step(alpha, y[:, t], g, leaky)
        alphas.append(alpha)
    return torch.logsumexp(alpha, dim=-1), torch.stack(alphas)


def den_backward(
    y: torch.Tensor,  # [B, T, P]
    g: DeviceDenGraph,
    log_z: torch.Tensor,  # [B]
    alphas: torch.Tensor,  # [T+1, B, S]
    leaky: float = 0.0,
) -> torch.Tensor:
    """Returns gamma [B, T, P] = d(log Z)/dy (denominator occupancies)."""
    y = y.detach().float()
    B, T, P = y.shape
    b = y.new_zeros((B, g.num_states))  # log dZ/dalpha'_t
    gamma = y.new_empty((B, T, P))
    for t in range(T - 1, -1, -1):
        b, gamma[:, t] = _bwd_step(b, y[:, t], alphas[t], g, log_z, leaky)
    return gamma


def den_forward_checkpointed(
    y: torch.Tensor,  # [B, T, P]
    g: DeviceDenGraph,
    leaky: float = 0.0,
    every: int = 10,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (log_z [B], checkpoints [T//every, B, S]): the post-leak
    alpha entering each segment of `every` frames.  Requires
    T % every == 0."""
    y = y.detach().float()
    B, T, _ = y.shape
    if T % every:
        raise ValueError(f"T={T} not divisible by checkpoint every={every}")
    alpha = _leak(g.log_init.expand(B, g.num_states), g.log_init, leaky)
    chks = []
    for t in range(T):
        if t % every == 0:
            chks.append(alpha)
        alpha = _fwd_step(alpha, y[:, t], g, leaky)
    return torch.logsumexp(alpha, dim=-1), torch.stack(chks)


def den_backward_checkpointed(
    y: torch.Tensor,  # [B, T, P]
    g: DeviceDenGraph,
    log_z: torch.Tensor,  # [B]
    chks: torch.Tensor,  # [T//every, B, S]
    leaky: float = 0.0,
    every: int = 10,
) -> torch.Tensor:
    """gamma [B, T, P]: each segment's alphas recomputed from its checkpoint,
    then its beta sweep, with the ops of den_backward."""
    y = y.detach().float()
    B, T, P = y.shape
    b = y.new_zeros((B, g.num_states))
    gamma = y.new_empty((B, T, P))
    for seg in range(T // every - 1, -1, -1):
        t0 = seg * every
        alphas = [chks[seg]]
        for t in range(t0, t0 + every - 1):
            alphas.append(_fwd_step(alphas[-1], y[:, t], g, leaky))
        for t in range(t0 + every - 1, t0 - 1, -1):
            b, gamma[:, t] = _bwd_step(b, y[:, t], alphas[t - t0], g, log_z, leaky)
    return gamma
