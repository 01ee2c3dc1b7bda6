"""Semi-orthogonal constraint for TDNN-F factored layers (torch), port of
torchain_tpu/models/semi_orthogonal.py.

Behavioral reference: Kaldi's `ConstrainOrthonormal` (nnet-utils.cc), the
periodic projection step of Povey et al. 2018 "Semi-Orthogonal Low-Rank
Matrix Factorization for Deep Neural Networks": for a wide matrix M
[rows <= cols], drive M M^T toward alpha I (alpha floating) with

    P     = M M^T
    alpha = trace(P P^T) / trace(P)                (floating scale)
    M    <- M - (nu / alpha) (P - alpha I) M       (nu = 0.25)

applied outside the gradient every few optimizer steps: plain matrix
products, in float32.
"""

from __future__ import annotations

import torch


def semi_orthogonal_step(M: torch.Tensor, nu: float = 0.5) -> torch.Tensor:
    """One constraint update on M [rows, cols], along the smaller dimension
    (transposed internally if rows > cols).  Where the matrix is far from
    orthonormal (trace(P P^T) rows / trace(P)^2 > 1.1) the speed drops to
    nu / 4, Kaldi's safeguard."""
    transpose = M.shape[0] > M.shape[1]
    W = (M.T if transpose else M).float()
    rows = W.shape[0]
    P = W @ W.T
    trace_p = torch.clamp(torch.trace(P), min=1e-20)
    trace_pp = torch.sum(torch.square(P))
    alpha = torch.clamp(trace_pp / trace_p, min=1e-20)
    ratio = trace_pp * rows / torch.square(trace_p)
    speed = torch.where(ratio > 1.1, nu * 0.25, nu)
    Q = P - alpha * torch.eye(rows, dtype=P.dtype, device=P.device)
    W = W - (speed / alpha) * (Q @ W)
    return W.T if transpose else W


def orthogonality_error(M: torch.Tensor) -> torch.Tensor:
    """||M M^T / alpha - I||_F / rows, a diagnostic for tests and logs."""
    W = (M.T if M.shape[0] > M.shape[1] else M).float()
    P = W @ W.T
    alpha = torch.sum(torch.square(P)) / torch.clamp(torch.trace(P), min=1e-20)
    eye = torch.eye(P.shape[0], dtype=P.dtype, device=P.device)
    return torch.linalg.norm(P / alpha - eye) / P.shape[0]


def constrained_parameters(model: torch.nn.Module) -> list[torch.nn.Parameter]:
    """The parameters `constrain_semi_orthogonal` acts on: every one whose
    name contains 'linear_pre' (the factored bottleneck kernels of TDNN-F)
    with two or more dimensions."""
    return [p for name, p in model.named_parameters() if "linear_pre" in name and p.ndim >= 2]


@torch.no_grad()
def constrain_semi_orthogonal(model: torch.nn.Module, nu: float = 0.25) -> int:
    """Apply the constraint step in place to every parameter of
    `constrained_parameters`.  A tap kernel [2, in, out] is constrained as
    the flattened (2*in) -> out linear map, Kaldi's ConstrainOrthonormal
    semantics.  Returns the number of parameters constrained."""
    params = constrained_parameters(model)
    for p in params:
        flat = p.reshape(-1, p.shape[-1])
        p.copy_(semi_orthogonal_step(flat, nu).reshape(p.shape))
    return len(params)
