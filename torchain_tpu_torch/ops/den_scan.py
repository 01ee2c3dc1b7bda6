"""Denominator forward-backward in the log semiring over sparse arcs.

Behavioral reference: kaldi/src/chain/chain-denominator.cc
(`DenominatorComputation::Forward/Backward`) and the per-arc kernels of
chain-kernels.cu, re-expressed in the LOG semiring (the same objective as
Kaldi's probability space with renormalization, conditioned another way).
Port of torchain_tpu/ops/den_scan.py (`den_forward`, `den_backward`): the
general form, for any arc structure, and the exactness reference of the
dense and slot-dense recursions.  It is plain PyTorch (`index_select`,
`scatter_reduce_`, `index_add_`) with one loop iteration per frame; the JAX
package has no kernel for it either.  Its alpha-checkpointed variant is not
ported.

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
        # arc values [A, B]: alpha'[src] + w + y_t[pdf]
        arc = alpha[:, g.in_src].T + g.in_logw[:, None] + y[:, t][:, g.in_pdf].T
        alpha = _leak(_seg_logsumexp(arc, g.in_dst, g.num_states).T, g.log_init, leaky)
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
    S = g.num_states
    b = y.new_zeros((B, S))  # log dZ/dalpha'_t
    gamma = y.new_empty((B, T, P))
    for t in range(T - 1, -1, -1):
        if leaky > 0.0:
            tot = torch.logsumexp(g.log_init + b, dim=-1, keepdim=True)
            b = torch.logaddexp(b, math.log(leaky) + tot)
        # one pass over the src-sorted arcs: arc_w feeds both the beta
        # pull-back and, combined with alpha, the gamma accumulation
        arc_w = g.out_logw[:, None] + y[:, t][:, g.out_pdf].T + b[:, g.out_dst].T
        arc_post = alphas[t][:, g.out_src].T + arc_w
        gamma[:, t] = y.new_zeros((P, B)).index_add_(
            0, g.out_pdf, torch.exp(arc_post - log_z)
        ).T
        b = _seg_logsumexp(arc_w, g.out_src, S).T
    return gamma
