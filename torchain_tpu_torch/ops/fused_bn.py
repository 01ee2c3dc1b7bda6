"""Train-mode batch normalization with closed-form backward (plain PyTorch).

Port of torchain_tpu/ops/fused_bn.py (which is not a Pallas kernel there
either).  Semantics of the JAX package's ChainBatchNorm: statistics over
all axes but the last, biased variance var = E[x^2] - E[x]^2 clipped at 0,
f32 reductions; the backward is

    dx = g * rstd * (dy - mean(dy) - xhat * mean(dy * xhat))

written as one multiply-add per element.  Each function returns
(y, mean, var); the running-statistic outputs get no gradient.

Inside a data-parallel step (`parallel.data_parallel`) the statistics are
the global batch's, as under the JAX package's GSPMD: one all-reduce of
the moments' sums in the forward and one of the gradient's sums in the
backward, each batchnorm.
"""

from __future__ import annotations

import functools

import torch

from torchain_tpu_torch.parallel.mesh import active_mesh, all_reduce_


@functools.lru_cache(maxsize=None)
def rounded_scalar(value: float, dtype: torch.dtype) -> float:
    """`value` rounded to `dtype`: the scalar a `dtype` computation uses."""
    return float(torch.tensor(value, dtype=dtype))


def _moments(x, mesh=None):
    """(mean, var, n) over all axes but the last; with `mesh` (the step's
    data axis) over every rank's rows: the sums s, sq and the count n are
    all-reduced, in one call, before the moments are formed."""
    axes = tuple(range(x.dim() - 1))
    n = x.numel() // x.shape[-1]
    s = torch.sum(x, dim=axes, dtype=torch.float32)
    sq = torch.sum(torch.square(x.float()), dim=axes)
    if mesh is not None:
        C = s.shape[0]
        v = all_reduce_(mesh, torch.cat([s, sq, s.new_full((1,), float(n))]))
        s, sq, n = v[:C], v[C:2 * C], v[2 * C]
    mean = s / n
    var = torch.clamp(sq / n - torch.square(mean), min=0.0)
    return mean, var, n


def _apply(h, scale, bias, eps, mesh=None):
    mean, var, n = _moments(h, mesh)
    rstd = torch.rsqrt(var + eps)
    sf32 = scale.float()
    a = (rstd * sf32).to(h.dtype)
    b = (bias.float() - mean * rstd * sf32).to(h.dtype)
    return h * a + b, mean, var, rstd, sf32, n


def _bwd_core(h, mean, rstd, sf32, dy, n, mesh=None):
    """(dh, dscale, dbias) of y = batchnorm(h), n the count the moments
    were taken over.  With `mesh`, dscale and dbias are this rank's rows'
    share (the train step's gradient all-reduce sums them) and dh is the
    whole derivative: the sums of dy and dy * h are all-reduced, in one
    call, before it is formed."""
    axes = tuple(range(h.dim() - 1))
    s_dy = torch.sum(dy, dim=axes, dtype=torch.float32)
    s_dyh = torch.sum(dy.float() * h.float(), dim=axes)
    dbias = s_dy
    dscale = (s_dyh - mean * s_dy) * rstd
    dscale_all = dscale
    if mesh is not None:
        C = s_dy.shape[0]
        v = all_reduce_(mesh, torch.cat([s_dy, s_dyh]))
        s_dy = v[:C]
        dscale_all = (v[C:] - mean * s_dy) * rstd
    g = sf32 * rstd
    A = g
    B = -g * rstd * dscale_all / n
    C = g * (mean * rstd * dscale_all - s_dy) / n
    dh = A.to(h.dtype) * dy + B.to(h.dtype) * h + C.to(h.dtype)
    return dh, dscale, dbias


class _BnTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        ctx.mesh = active_mesh()
        y, mean, var, rstd, sf32, ctx.n = _apply(x, scale, bias, eps, ctx.mesh)
        ctx.save_for_backward(x, mean, rstd, sf32)
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, mean, rstd, sf32 = ctx.saved_tensors
        dx, dscale, dbias = _bwd_core(x, mean, rstd, sf32, dy, ctx.n, ctx.mesh)
        return dx, dscale, dbias, None


class _BrbTrain(torch.autograd.Function):
    """y = batchnorm(relu(x + cb)) [+ bypass_scale * byp]; relu(x + cb) is
    recomputed in the backward instead of saved."""

    @staticmethod
    def forward(ctx, x, cb, scale, bias, byp, eps, bypass_scale):
        h = torch.clamp(x + cb.to(x.dtype), min=0)
        ctx.mesh = active_mesh()
        y, mean, var, rstd, sf32, ctx.n = _apply(h, scale, bias, eps, ctx.mesh)
        if byp is not None:
            y = y + rounded_scalar(bypass_scale, y.dtype) * byp.to(y.dtype)
        ctx.bypass_scale = bypass_scale
        ctx.has_byp = byp is not None
        ctx.save_for_backward(x, cb, mean, rstd, sf32)
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, cb, mean, rstd, sf32 = ctx.saved_tensors
        xp = x + cb.to(x.dtype)
        h = torch.clamp(xp, min=0)
        dh, dscale, dbias = _bwd_core(h, mean, rstd, sf32, dy, ctx.n, ctx.mesh)
        dx = torch.where(xp > 0, dh, torch.zeros((), dtype=x.dtype))
        dcb = torch.sum(dx, dim=tuple(range(x.dim() - 1)), dtype=torch.float32)
        dbyp = rounded_scalar(ctx.bypass_scale, dy.dtype) * dy if ctx.has_byp else None
        return dx, dcb, dscale, dbias, dbyp, None, None


def bn_train(x, scale, bias, eps: float):
    """Batch-normalize `x` over all axes but the last; (y, mean, var)."""
    return _BnTrain.apply(x, scale, bias, eps)


def brb_train(x, cb, scale, bias, eps: float):
    """y = batchnorm(relu(x + cb)); (y, mean, var)."""
    return _BrbTrain.apply(x, cb, scale, bias, None, eps, 0.0)


def brb_bypass_train(x, cb, scale, bias, byp, eps: float, bypass_scale: float):
    """y = batchnorm(relu(x + cb)) + bypass_scale * byp; (y, mean, var)."""
    return _BrbTrain.apply(x, cb, scale, bias, byp, eps, bypass_scale)
