"""Fused multi-head self-attention with relative-position bias: kernels K7f
(forward) and K7b (backward).

Port of torchain_tpu/ops/attention.py.  Semantics (the conformer block's
attention):

    out[b, t, h*dh:(h+1)*dh] = softmax(scale * q_h @ k_h^T + bias[h]) @ v_h

with q_h = qkv[b, :, h*dh + 0*D], k_h = +1*D, v_h = +2*D slices of qkv
[B, T, 3D] and bias [H, T, T].  All products and the softmax run in
float32 whatever qkv's dtype; the probabilities are NOT rounded to qkv's
dtype before the product with v (the kernel's arithmetic; the einsum
formulation `reference_relpos_attention` does round them).  The backward
recomputes the softmax instead of saving [B, H, T, T] probabilities and
returns dqkv in qkv's dtype and the bias gradient, summed over the batch in
batch order, in float32.

On a CUDA tensor `attention_forward` / `attention_backward` each launch
their kernel of csrc/attention.cu (one thread block per (batch row, head)
pair; K7b is followed by its fixed-order reduction of the bias gradient
over the batch, in the same entry point); on a CPU tensor the plain PyTorch
version beside them runs.  The kernels keep q, k, v (and the incoming
gradient) of one head with the [T, T] logits in shared memory, so T and dh
are bounded by what fits there: `attention_forward` needs
4*(3*T*(dh+1) + T*T) bytes of the card's 232,448 per block (T <= 162 at
dh 64), `attention_backward` 4*(4*T*(dh+1) + 2*T*T) (T <= 117), and each
wrapper raises beyond its own limit.
"""

from __future__ import annotations

import torch

from torchain_tpu_torch import kernels

_DTYPES = (torch.float32, torch.bfloat16)


def _heads(qkv: torch.Tensor, num_heads: int):
    """qkv [B, T, 3D] -> q, k, v [B, H, T, dh] (views)."""
    B, T, D3 = qkv.shape
    D = D3 // 3
    dh = D // num_heads
    return tuple(
        qkv[..., i * D : (i + 1) * D].reshape(B, T, num_heads, dh).permute(0, 2, 1, 3)
        for i in range(3)
    )


def _merge(x: torch.Tensor) -> torch.Tensor:
    """[B, H, T, dh] -> [B, T, H*dh]."""
    B, H, T, dh = x.shape
    return x.permute(0, 2, 1, 3).reshape(B, T, H * dh)


def _softmax_f32(logits: torch.Tensor) -> torch.Tensor:
    p = torch.exp(logits - logits.amax(-1, keepdim=True))
    return p / p.sum(-1, keepdim=True)


def _probs(qkv, bias, num_heads, scale):
    q, k, v = _heads(qkv.float(), num_heads)
    logits = q @ k.transpose(-1, -2) * scale + bias.float()[None]
    return q, k, v, _softmax_f32(logits)


def attention_forward_plain(qkv, bias, num_heads: int, scale: float) -> torch.Tensor:
    """Plain K7f: qkv [B, T, 3D], bias [H, T, T] -> out [B, T, D] in
    qkv.dtype, every product and the softmax in float32."""
    _, _, v, p = _probs(qkv, bias, num_heads, scale)
    return _merge(p @ v).to(qkv.dtype)


def attention_backward_plain(qkv, bias, g, num_heads: int, scale: float):
    """Plain K7b: (dqkv [B, T, 3D] in qkv.dtype, dbias [H, T, T] float32)
    for the output gradient g [B, T, D]; the softmax is recomputed."""
    B, T, D3 = qkv.shape
    D = D3 // 3
    q, k, v, p = _probs(qkv, bias, num_heads, scale)
    go = g.float().reshape(B, T, num_heads, D // num_heads).permute(0, 2, 1, 3)
    dv = p.transpose(-1, -2) @ go
    dp = go @ v.transpose(-1, -2)
    dl = p * (dp - (dp * p).sum(-1, keepdim=True))
    dq = dl @ k * scale
    dk = dl.transpose(-1, -2) @ q * scale
    dqkv = torch.cat([_merge(dq), _merge(dk), _merge(dv)], dim=-1).to(qkv.dtype)
    return dqkv, dl.sum(0)


def _check_args(qkv, bias, num_heads):
    """Shapes and types both kernels take; returns (B, T, H, dh)."""
    if qkv.dim() != 3 or qkv.shape[-1] % (3 * num_heads):
        raise ValueError(f"qkv: expected [B, T, 3*H*dh] with H={num_heads}, got {tuple(qkv.shape)}")
    kernels.check_tensor("qkv", qkv, qkv.dtype)  # on the card, contiguous
    if qkv.dtype not in _DTYPES:
        raise TypeError(f"qkv: expected float32 or bfloat16, got {qkv.dtype}")
    B, T, D3 = qkv.shape
    kernels.check_tensor("bias", bias, torch.float32, (num_heads, T, T))
    return B, T, num_heads, D3 // 3 // num_heads


def _check_fits(lib, T, dh, backward: int):
    """Raise unless the forward (backward=0) or the backward (1) kernel's
    block fits the card's shared memory at this T and dh."""
    need = lib.attention_shared_bytes(T, dh, backward)
    limit = lib.attention_shared_limit()
    if need > limit:
        what = "attention_backward" if backward else "attention_forward"
        raise ValueError(
            f"{what}: T={T}, dh={dh} needs {need} bytes of shared memory per block,"
            f" the card gives {limit}"
        )


def attention_forward(qkv, bias, num_heads: int, scale: float) -> torch.Tensor:
    """K7f.  Launches csrc/attention.cu:attention_forward on a CUDA tensor."""
    if qkv.device.type == "cpu":
        return attention_forward_plain(qkv, bias, num_heads, scale)
    B, T, H, dh = _check_args(qkv, bias, num_heads)
    lib = kernels.library("attention")
    _check_fits(lib, T, dh, 0)
    out = torch.empty((B, T, H * dh), device=qkv.device, dtype=qkv.dtype)
    if out.numel() == 0:
        return out
    err = lib.attention_forward(
        qkv.data_ptr(), bias.data_ptr(), out.data_ptr(), B, T, H, dh, float(scale),
        int(qkv.dtype == torch.bfloat16), kernels.stream_of(qkv.device),
    )
    kernels.check(lib, err, "attention_forward")
    attention_forward.launches += 1
    return out


attention_forward.launches = 0


def attention_backward(qkv, bias, g, num_heads: int, scale: float):
    """K7b.  Launches csrc/attention.cu:attention_backward on a CUDA tensor:
    one block per (batch row, head) writes its dqkv slices and its [T, T]
    logit gradient into a [B, H, T, T] scratch, then a second pass sums the
    scratch over the batch in batch order (no atomics)."""
    if qkv.device.type == "cpu":
        return attention_backward_plain(qkv, bias, g, num_heads, scale)
    B, T, H, dh = _check_args(qkv, bias, num_heads)
    kernels.check_tensor("g", g, qkv.dtype, (B, T, H * dh))
    lib = kernels.library("attention")
    _check_fits(lib, T, dh, 1)
    dqkv = torch.empty_like(qkv)
    dbias = torch.empty((H, T, T), device=qkv.device, dtype=torch.float32)
    if qkv.numel() == 0:
        return dqkv, dbias.zero_()
    dl = torch.empty((B, H, T, T), device=qkv.device, dtype=torch.float32)
    err = lib.attention_backward(
        qkv.data_ptr(), bias.data_ptr(), g.data_ptr(), dqkv.data_ptr(), dl.data_ptr(),
        dbias.data_ptr(), B, T, H, dh, float(scale),
        int(qkv.dtype == torch.bfloat16), kernels.stream_of(qkv.device),
    )
    kernels.check(lib, err, "attention_backward")
    attention_backward.launches += 1
    return dqkv, dbias


attention_backward.launches = 0


class _FusedRelposAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, bias, num_heads, scale):
        qkv = qkv.contiguous()
        bias32 = bias.float().contiguous()
        ctx.save_for_backward(qkv, bias32)
        ctx.num_heads, ctx.scale, ctx.bias_dtype = num_heads, scale, bias.dtype
        return attention_forward(qkv, bias32, num_heads, scale)

    @staticmethod
    def backward(ctx, g):
        qkv, bias32 = ctx.saved_tensors
        dqkv, dbias = attention_backward(
            qkv, bias32, g.to(qkv.dtype).contiguous(), ctx.num_heads, ctx.scale
        )
        # accumulated in float32, cast to the bias's dtype last
        return dqkv, dbias.to(ctx.bias_dtype), None, None


def fused_relpos_attention(qkv, bias, num_heads: int, scale: float) -> torch.Tensor:
    """softmax(scale * q_h k_h^T + bias_h) v_h per head, merged to [B, T, D]
    in qkv.dtype; differentiable in qkv and bias (K7f / K7b)."""
    return _FusedRelposAttention.apply(qkv, bias, int(num_heads), float(scale))


def reference_relpos_attention(qkv, bias, num_heads: int, scale: float) -> torch.Tensor:
    """The einsum formulation the kernel replaces (logits accumulated in
    float32, probabilities rounded to qkv.dtype before the product with v):
    a readable specification for the tests, differentiable by autograd."""
    q, k, v = _heads(qkv, num_heads)
    logits = (q.float() @ k.float().transpose(-1, -2)) * scale + bias.float()[None]
    p = torch.softmax(logits, dim=-1).to(v.dtype)
    return _merge(p @ v)
