"""Fused conformer feed-forward half-step: kernels K10f (forward) and K10b
(backward).

Port of torchain_tpu/ops/fused_ffn.py:

    out = res + alpha * (swish(xn @ W1 + b1) @ W2 + b2)

with xn the pre-norm LayerNorm output and alpha = 0.5.  xn and res are in
the trunk dtype (float32 or bfloat16); W1 [D, F] and W2 [F, D] are float32
parameters cast to the trunk dtype outside the kernel; b1, b2 stay
float32.  Both products accumulate in float32, swish and its derivative run
in float32, and the hidden activations h are rounded to the trunk dtype
before the second product.  The backward recomputes u, sigmoid and h and
keeps the roundings of the TPU kernel's body: dhb = round(dh) feeds dx and
dW1, db1 sums the unrounded dh, dW2 = alpha * (h^T g), db2 = alpha * sum(g)
with g already in the trunk dtype, and d res = g.

On a CUDA tensor `ffn_forward` / `ffn_backward` each launch their kernel of
csrc/fused_ffn.cu, whose products run on the tensor cores (wgmma for
bfloat16 operands, 3xTF32 mma.sync for float32); the backward is two
device launches in one entry point: the row pass, then the weight-gradient
tiles with the fixed-order sums of the bias gradients.  On a CPU tensor the
plain PyTorch version beside them runs.  The kernels take any N, D and F:
a block computes at most 384 output columns, so rows wider than that (a
conformer of dim 512) are cut into column groups, each of which recomputes
the hidden chunk, and the forward streams xn in slices where its [64, D]
tile would not fit (float32 D > 352; `ffn_shared_bytes` in the source).

Under a model axis the half-step's hidden columns are split over the model
group (models/conformer.py): `ffn_partial` is one rank's share, alpha *
(swish(xn @ W1s + b1s) @ W2s) over its columns, which both kernels compute
with `partial` set: the output and dx float32 and unrounded, so that the
sum over the group rounds once, where the unsplit kernel rounds.
"""

from __future__ import annotations

import torch

from torchain_tpu_torch import kernels

_DTYPES = (torch.float32, torch.bfloat16)


def _hidden(xn, w1, b1):
    u = xn.float() @ w1.float() + b1.float()
    sig = torch.sigmoid(u)
    return u, sig, (u * sig).to(xn.dtype)


def ffn_forward_plain(xn, res, w1, b1, w2, b2, alpha: float,
                      partial: bool = False) -> torch.Tensor:
    """Plain K10f: xn, res [N, D], w1 [D, F], w2 [F, D] (cast to xn.dtype
    here if they are not yet), b1 [F], b2 [D] -> out [N, D] in xn.dtype;
    with `partial`, alpha * (h @ W2) [N, D] float32 (res and b2 unread)."""
    dt = xn.dtype
    _, _, h = _hidden(xn, w1.to(dt), b1)
    if partial:
        return alpha * (h.float() @ w2.to(dt).float())
    out = h.float() @ w2.to(dt).float() + b2.float()
    return (res.float() + alpha * out).to(dt)


def ffn_backward_plain(xn, g, w1, b1, w2, alpha: float, partial: bool = False):
    """Plain K10b: (dx [N, D] in xn.dtype, float32 with `partial`; dW1 [D,
    F], db1 [F], dW2 [F, D], db2 [D] float32) for the output gradient g [N,
    D], with the kernel's roundings (not autograd of the forward, which
    rounds elsewhere)."""
    dt = xn.dtype
    w1f, w2f = w1.to(dt).float(), w2.to(dt).float()
    gf = g.to(dt).float()
    u, sig, h = _hidden(xn, w1f, b1)
    dh = (gf @ w2f.t()) * alpha * (sig * (1.0 + u * (1.0 - sig)))
    dhb = dh.to(dt).float()
    dx = dhb @ w1f.t()
    if not partial:
        dx = dx.to(dt)
    dw1 = xn.float().t() @ dhb
    db1 = dh.sum(0)
    dw2 = alpha * (h.float().t() @ gf)
    db2 = alpha * gf.sum(0)
    return dx, dw1, db1, dw2, db2


def _check_args(xn, w1, b1, w2):
    """Shapes and types both kernels take; returns (N, D, F)."""
    if xn.dim() != 2 or w1.dim() != 2 or w1.shape[1] == 0:
        raise ValueError(f"expected xn [N, D] and w1 [D, F], got {tuple(xn.shape)}, {tuple(w1.shape)}")
    kernels.check_tensor("xn", xn, xn.dtype)  # on the card, contiguous
    if xn.dtype not in _DTYPES:
        raise TypeError(f"xn: expected float32 or bfloat16, got {xn.dtype}")
    N, D = xn.shape
    F = w1.shape[1]
    kernels.check_tensor("w1", w1, xn.dtype, (D, F))
    kernels.check_tensor("w2", w2, xn.dtype, (F, D))
    kernels.check_tensor("b1", b1, torch.float32, (F,))
    return N, D, F


#: (D, is_bf16, backward, device index) already found to fit
_FITS: set[tuple[int, int, int, int]] = set()


def _check_fits(lib, D, is_bf16, backward, device):
    """Raises before a launch where the kernel's block would ask for more
    shared memory than the card gives (on the H100 no width does)."""
    key = (D, is_bf16, backward, device.index)
    if key in _FITS:
        return
    need = lib.ffn_shared_bytes(D, is_bf16, backward)
    limit = lib.ffn_shared_limit()
    if need > limit:
        raise ValueError(
            f"ffn: D={D} does not fit one block's shared memory"
            f" (needs {need} bytes, the card gives {limit})"
        )
    _FITS.add(key)


def ffn_forward(xn, res, w1, b1, w2, b2, alpha: float, partial: bool = False) -> torch.Tensor:
    """K10f.  Launches csrc/fused_ffn.cu:ffn_forward on a CUDA tensor (w1
    and w2 already in xn.dtype, b1 and b2 float32); with `partial` (res and
    b2 may be None) the output is a split half-step's share, float32."""
    if xn.device.type == "cpu":
        return ffn_forward_plain(xn, res, w1, b1, w2, b2, alpha, partial)
    N, D, F = _check_args(xn, w1, b1, w2)
    if not partial:
        kernels.check_tensor("res", res, xn.dtype, (N, D))
        kernels.check_tensor("b2", b2, torch.float32, (D,))
    lib = kernels.library("fused_ffn")
    is_bf16 = int(xn.dtype == torch.bfloat16)
    _check_fits(lib, D, is_bf16, 0, xn.device)
    out = torch.empty((N, D), device=xn.device,
                      dtype=torch.float32 if partial else xn.dtype)
    if out.numel() == 0:
        return out
    err = lib.ffn_forward(
        xn.data_ptr(), 0 if partial else res.data_ptr(), w1.data_ptr(), b1.data_ptr(),
        w2.data_ptr(), 0 if partial else b2.data_ptr(), out.data_ptr(), N, D, F, float(alpha),
        is_bf16, int(partial), kernels.stream_of(xn.device),
    )
    kernels.check(lib, err, "ffn_forward")
    ffn_forward.launches += 1
    return out


ffn_forward.launches = 0


def ffn_backward(xn, g, w1, b1, w2, alpha: float, partial: bool = False):
    """K10b.  Launches csrc/fused_ffn.cu:ffn_backward on a CUDA tensor (w1
    and w2 already in xn.dtype, read in their stored layouts; with
    `partial` dx is float32).  The scratch (h and dhb [N, F] in xn.dtype,
    per-block bias sums) is made here."""
    if xn.device.type == "cpu":
        return ffn_backward_plain(xn, g, w1, b1, w2, alpha, partial)
    N, D, F = _check_args(xn, w1, b1, w2)
    kernels.check_tensor("g", g, xn.dtype, (N, D))
    lib = kernels.library("fused_ffn")
    is_bf16 = int(xn.dtype == torch.bfloat16)
    _check_fits(lib, D, is_bf16, 1, xn.device)
    dev, f32 = xn.device, torch.float32
    dx = torch.empty((N, D), device=dev, dtype=f32 if partial else xn.dtype)
    dw1 = torch.empty((D, F), device=dev, dtype=f32)
    db1 = torch.empty((F,), device=dev, dtype=f32)
    dw2 = torch.empty((F, D), device=dev, dtype=f32)
    db2 = torch.empty((D,), device=dev, dtype=f32)
    if xn.numel() == 0:
        return dx, dw1.zero_(), db1.zero_(), dw2.zero_(), db2.zero_()
    blocks = -(-N // lib.ffn_rows_per_block())
    hbuf = torch.empty((N, F), device=dev, dtype=xn.dtype)
    dhbuf = torch.empty((N, F), device=dev, dtype=xn.dtype)
    db1_part = torch.empty((blocks, F), device=dev, dtype=f32)
    db2_part = torch.empty((blocks, D), device=dev, dtype=f32)
    err = lib.ffn_backward(
        xn.data_ptr(), g.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
        dx.data_ptr(), hbuf.data_ptr(), dhbuf.data_ptr(),
        db1_part.data_ptr(), db2_part.data_ptr(), dw1.data_ptr(), db1.data_ptr(),
        dw2.data_ptr(), db2.data_ptr(), N, D, F, float(alpha), is_bf16, int(partial),
        kernels.stream_of(dev),
    )
    kernels.check(lib, err, "ffn_backward")
    ffn_backward.launches += 1
    return dx, dw1, db1, dw2, db2


ffn_backward.launches = 0


class _FfnApply(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xn, res, w1, b1, w2, b2, alpha):
        dt = xn.dtype
        xn, res = xn.contiguous(), res.to(dt).contiguous()
        # the casts to the trunk dtype happen outside the kernel
        w1c, w2c = w1.to(dt).contiguous(), w2.to(dt).contiguous()
        b1f, b2f = b1.float().contiguous(), b2.float().contiguous()
        ctx.save_for_backward(xn, w1c, b1f, w2c)
        ctx.alpha = alpha
        ctx.param_dtypes = (w1.dtype, b1.dtype, w2.dtype, b2.dtype)
        return ffn_forward(xn, res, w1c, b1f, w2c, b2f, alpha)

    @staticmethod
    def backward(ctx, g):
        xn, w1c, b1f, w2c = ctx.saved_tensors
        g = g.to(xn.dtype).contiguous()
        dx, *dparams = ffn_backward(xn, g, w1c, b1f, w2c, ctx.alpha)
        dw1, db1, dw2, db2 = (p.to(t) for p, t in zip(dparams, ctx.param_dtypes))
        # the residual passes the gradient through
        return dx, g, dw1, db1, dw2, db2, None


class _FfnPartial(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x32, w1, b1, w2, alpha, dtype):
        # x32 holds trunk-dtype values in float32: the cast back is exact
        xn = x32.to(dtype).contiguous()
        w1c, w2c = w1.to(dtype).contiguous(), w2.to(dtype).contiguous()
        b1f = b1.float().contiguous()
        ctx.save_for_backward(xn, w1c, b1f, w2c)
        ctx.alpha = alpha
        ctx.param_dtypes = (w1.dtype, b1.dtype, w2.dtype)
        return ffn_forward(xn, None, w1c, b1f, w2c, None, alpha, partial=True)

    @staticmethod
    def backward(ctx, g):
        xn, w1c, b1f, w2c = ctx.saved_tensors
        # the share's gradient is the half-step's output gradient, whose
        # values are in the trunk dtype: the cast is exact
        g = g.to(xn.dtype).contiguous()
        dx, dw1, db1, dw2, _ = ffn_backward(xn, g, w1c, b1f, w2c, ctx.alpha, partial=True)
        dw1, db1, dw2 = (p.to(t) for p, t in zip((dw1, db1, dw2), ctx.param_dtypes))
        return dx, dw1, db1, dw2, None, None


def ffn_partial(x32, w1, b1, w2, alpha: float, dtype) -> torch.Tensor:
    """One model rank's share of a split half-step over [..., D] rows:
    alpha * (swish(xn @ W1 + b1) @ W2) float32, for this rank's hidden
    columns (w1 [D, Fs], b1 [Fs], w2 [Fs, D]); x32 is xn (trunk `dtype`
    values) in float32, and its gradient, this rank's share of dxn, comes
    back float32.  Differentiable in x32, w1, b1 and w2: K10f / K10b with
    `partial`."""
    D = x32.shape[-1]
    out = _FfnPartial.apply(x32.reshape(-1, D), w1, b1, w2, float(alpha), dtype)
    return out.reshape(*x32.shape[:-1], D)


def ffn_apply(xn, res, w1, b1, w2, b2, alpha: float = 0.5) -> torch.Tensor:
    """res + alpha * (swish(xn @ W1 + b1) @ W2 + b2) over [..., D] operands,
    differentiable in all six: K10f / K10b."""
    D = xn.shape[-1]
    out = _FfnApply.apply(xn.reshape(-1, D), res.reshape(-1, D), w1, b1, w2, b2, float(alpha))
    return out.reshape(*xn.shape[:-1], D)
