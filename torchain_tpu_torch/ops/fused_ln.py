"""LayerNorm over the last axis with closed-form backward (plain PyTorch).

Port of torchain_tpu/ops/fused_ln.py (which is not a Pallas kernel there
either): the pre-norm LayerNorms of the conformer blocks.  Row statistics
are float32 straight off the operand (bfloat16 in a bf16 trunk), the
variance is max(E[x^2] - mean^2, 0), the output is in x.dtype, and the
gradients of scale and bias are float32.  The backward is

    w  = dy * scale
    dx = rstd * (w - mean_r(w) - xhat * mean_r(w * xhat))

with xhat recomputed from the saved row mean and rstd.
"""

from __future__ import annotations

import torch


class _LnApply(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = torch.clamp(torch.square(xf).mean(-1, keepdim=True) - torch.square(mean), min=0.0)
        rstd = torch.rsqrt(var + eps)
        xhat = (xf - mean) * rstd
        ctx.save_for_backward(x, mean, rstd, scale)
        return (xhat * scale.float() + bias.float()).to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        x, mean, rstd, scale = ctx.saved_tensors
        dyf = dy.float()
        xhat = (x.float() - mean) * rstd
        rows = tuple(range(x.dim() - 1))
        dbias = dyf.sum(rows)
        dscale = (dyf * xhat).sum(rows)
        w = dyf * scale.float()
        mw = w.mean(-1, keepdim=True)
        mwx = (w * xhat).mean(-1, keepdim=True)
        dx = (rstd * (w - mw - xhat * mwx)).to(x.dtype)
        return dx, dscale.to(scale.dtype), dbias.to(scale.dtype), None


def ln_apply(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float) -> torch.Tensor:
    """LayerNorm over the last axis of `x`; returns y in x.dtype."""
    return _LnApply.apply(x, scale, bias, eps)
