"""Train-mode batch normalization with closed-form backward (plain PyTorch).

Port of torchain_tpu/ops/fused_bn.py (which is not a Pallas kernel there
either).  Semantics of the JAX package's ChainBatchNorm: statistics over
all axes but the last, biased variance var = E[x^2] - E[x]^2 clipped at 0,
f32 reductions; the backward is

    dx = g * rstd * (dy - mean(dy) - xhat * mean(dy * xhat))

written as one multiply-add per element.  Each function returns
(y, mean, var); the running-statistic outputs get no gradient.
"""

from __future__ import annotations

import functools

import torch


@functools.lru_cache(maxsize=None)
def rounded_scalar(value: float, dtype: torch.dtype) -> float:
    """`value` rounded to `dtype`: the scalar a `dtype` computation uses."""
    return float(torch.tensor(value, dtype=dtype))


def _moments(x):
    axes = tuple(range(x.dim() - 1))
    n = x.numel() // x.shape[-1]
    s = torch.sum(x, dim=axes, dtype=torch.float32)
    sq = torch.sum(torch.square(x.float()), dim=axes)
    mean = s / n
    var = torch.clamp(sq / n - torch.square(mean), min=0.0)
    return mean, var, n


def _apply(h, scale, bias, eps):
    mean, var, _ = _moments(h)
    rstd = torch.rsqrt(var + eps)
    sf32 = scale.float()
    a = (rstd * sf32).to(h.dtype)
    b = (bias.float() - mean * rstd * sf32).to(h.dtype)
    return h * a + b, mean, var, rstd, sf32


def _bwd_core(h, mean, rstd, sf32, dy):
    """(dh, dscale, dbias) of y = batchnorm(h)."""
    axes = tuple(range(h.dim() - 1))
    n = h.numel() // h.shape[-1]
    s_dy = torch.sum(dy, dim=axes, dtype=torch.float32)
    s_dyh = torch.sum(dy.float() * h.float(), dim=axes)
    dbias = s_dy
    dscale = (s_dyh - mean * s_dy) * rstd
    g = sf32 * rstd
    A = g
    B = -g * rstd * dscale / n
    C = g * (mean * rstd * dscale - s_dy) / n
    dh = A.to(h.dtype) * dy + B.to(h.dtype) * h + C.to(h.dtype)
    return dh, dscale, dbias


class _BnTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        y, mean, var, rstd, sf32 = _apply(x, scale, bias, eps)
        ctx.save_for_backward(x, mean, rstd, sf32)
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, mean, rstd, sf32 = ctx.saved_tensors
        dx, dscale, dbias = _bwd_core(x, mean, rstd, sf32, dy)
        return dx, dscale, dbias, None


class _BrbTrain(torch.autograd.Function):
    """y = batchnorm(relu(x + cb)) [+ bypass_scale * byp]; relu(x + cb) is
    recomputed in the backward instead of saved."""

    @staticmethod
    def forward(ctx, x, cb, scale, bias, byp, eps, bypass_scale):
        h = torch.clamp(x + cb.to(x.dtype), min=0)
        y, mean, var, rstd, sf32 = _apply(h, scale, bias, eps)
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
        dh, dscale, dbias = _bwd_core(h, mean, rstd, sf32, dy)
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
