"""Conformer acoustic encoder (torch), port of torchain_tpu/models/conformer.py
under each of its lowerings: LayerNorm fused (ops.fused_ln) or flax's
(`FlaxLayerNorm`, float32, cast back), batchnorm fused or flax's, attention
fused (ops.attention, kernels K7f/K7b) or "einsum" (plain matrix products:
q scaled first, the logits in float32, the softmax cast to v's dtype, as
the JAX package runs it outside any Pallas kernel), the depthwise
convolution as shifted multiply-adds or as a grouped convolution (a
float32 island in a bfloat16 trunk, as in the JAX package), and the
feed-forward dense or fused (K10f/K10b).

Standard conformer blocks (Gulati et al. 2020): half-step feed-forward
sandwiches around multi-head self-attention (with a T5-style relative
position bias shared by the layers) and a depthwise-convolution module; a
strided VALID convolution in front performs the frame-subsampling
reduction.

`ConformerConfig.dtype` is the compute dtype of the trunk: parameters stay
float32 and are cast where they are used, LayerNorm and batchnorm compute
in float32 and return the trunk dtype, and the heads emit float32.  The
casts are explicit (no autocast), so the CPU and the card do the same
thing.  The frontend is written as unfold + matmul, so that no cuDNN
convolution (TF32 by default) is involved on the card.

Parameters keep the JAX package's names and shapes (`frontend.kernel
[K, F, dim]`, `block{i}.attn_qkv.kernel [D, 3D]`, `block{i}.depthwise.kernel
[K, 1, dim]`, `rel_pos.rel_bias [2*buckets+1, H]`, ...) so
`convert.params_from_jax` is a plain renaming.  The model returns
(chain_out, xent_out): [B, T_out, num_pdfs].

Under the model axis (`parallel.shard_params`) each block's feed-forward
half-steps run split over the model group, their kernels held as this
rank's column block of W1 and row block of W2 (`ConformerBlock.
split_over_model`); any other sharded leaf is gathered on use.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn
from torch.nn import functional as F

from torchain_tpu_torch.models.cnn import conv
from torchain_tpu_torch.models.tdnn import (
    Dense,
    Prefinal,
    _param,
    batch_norm,
    check_lowerings,
    continuous_dropout,
)
from torchain_tpu_torch.ops.attention import fused_relpos_attention
from torchain_tpu_torch.ops.fused_bn import rounded_scalar
from torchain_tpu_torch.ops.fused_ffn import ffn_apply, ffn_partial
from torchain_tpu_torch.ops.fused_ln import ln_apply
from torchain_tpu_torch.parallel.sharding import sum_over_model_group, to_model_group, whole


@dataclasses.dataclass(frozen=True)
class ConformerConfig:
    num_pdfs: int = 120
    dim: int = 256
    num_layers: int = 8
    num_heads: int = 4
    ffn_mult: int = 4
    conv_kernel: int = 15
    frame_subsampling_factor: int = 3
    frontend_kernel: int = 5
    rel_pos_buckets: int = 32
    prefinal_dim: int = 256
    dropout: float = 0.0
    #: compute dtype of the trunk (parameters stay float32)
    dtype: torch.dtype = torch.float32
    #: run the depthwise taps in float32 whatever the trunk dtype (the
    #: "conv" lowering does so in a bfloat16 trunk in any case)
    depthwise_f32: bool = False
    #: depthwise lowering: "shift" (shifted multiply-adds) or "conv" (a
    #: grouped convolution)
    depthwise_impl: str = "shift"
    #: batchnorm lowering: "fused" (ops.fused_bn) or "flax" (FlaxBatchNorm)
    bn_impl: str = "fused"
    #: LayerNorm lowering: "fused" (ops.fused_ln) or "flax" (FlaxLayerNorm)
    ln_impl: str = "fused"
    #: attention lowering: "fused" (ops.attention, kernels K7f / K7b) or
    #: "einsum" (plain matrix products)
    attn_impl: str = "fused"
    #: feed-forward lowering: "dense" = two Dense layers around a swish
    #: (default, as in the JAX package), "fused" = ops.fused_ffn.ffn_apply
    #: (kernels K10f / K10b).  The parameters are the same either way
    ffn_impl: str = "dense"

    def __post_init__(self):
        check_lowerings(self, depthwise_impl=("shift", "conv"), bn_impl=("fused", "flax"),
                        ln_impl=("fused", "flax"), attn_impl=("fused", "einsum"),
                        ffn_impl=("dense", "fused"))
        if self.dim % self.num_heads:
            raise ValueError(f"dim {self.dim} is not a multiple of num_heads {self.num_heads}")

    @property
    def context(self) -> tuple[int, int]:
        c = (self.frontend_kernel - 1) // 2
        return c, c


def swish(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(x) as two ops in x.dtype (each rounds, as in the JAX
    package; `F.silu` would round once)."""
    return x * torch.sigmoid(x)


class FusedLayerNorm(nn.Module):
    """LayerNorm over the last axis through ops.fused_ln.ln_apply: float32
    row statistics straight off the operand, output in `dtype`; scale and
    bias float32, eps 1e-6."""

    def __init__(self, C: int, eps: float = 1e-6, dtype=torch.float32, device=None):
        super().__init__()
        self.eps, self.dtype = eps, dtype
        self.scale = _param((C,), device, fill=1.0)
        self.bias = _param((C,), device, fill=0.0)

    def forward(self, x):
        return ln_apply(x.to(self.dtype), self.scale, self.bias, self.eps)


class FlaxLayerNorm(nn.Module):
    """flax's stock nn.LayerNorm over the last axis in float32: float32 row
    statistics (the variance as max(0, E[x^2] - mean^2)), y = (x - mean) *
    (rsqrt(var + eps) * scale) + bias, returned in float32; eps 1e-6."""

    def __init__(self, C: int, eps: float = 1e-6, device=None):
        super().__init__()
        self.eps = eps
        self.scale = _param((C,), device, fill=1.0)
        self.bias = _param((C,), device, fill=0.0)

    def forward(self, x):
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = torch.clamp(torch.square(xf).mean(-1, keepdim=True) - torch.square(mean), min=0.0)
        return (xf - mean) * (torch.rsqrt(var + self.eps) * self.scale) + self.bias


def einsum_attention(qkv: torch.Tensor, bias: torch.Tensor, num_heads: int,
                     scale: float) -> torch.Tensor:
    """softmax(scale * q k^T + bias) v per head, as the JAX package's
    `attn_impl="einsum"` computes it: qkv [B, T, 3D] in the trunk dtype,
    bias [H, T, T] float32; q scaled first (the scale rounded to q's dtype),
    the logits and the softmax in float32, the probabilities cast to v's
    dtype for the second product.  Returns [B, T, D]."""
    B, T, D3 = qkv.shape
    D = D3 // 3
    q, k, v = (qkv[..., i * D:(i + 1) * D].reshape(B, T, num_heads, D // num_heads)
               .transpose(1, 2) for i in range(3))
    q = q * rounded_scalar(scale, q.dtype)
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) + bias
    att = torch.matmul(torch.softmax(logits, dim=-1).to(v.dtype), v)
    return att.transpose(1, 2).reshape(B, T, D)


class RelPositionBias(nn.Module):
    """T5-style bucketed relative position bias shared across layers:
    rel_bias [2*buckets+1, H] gathered at clip(s - t) into [H, T, T]."""

    def __init__(self, num_heads: int, num_buckets: int = 32, device=None, generator=None):
        super().__init__()
        self.num_buckets = num_buckets
        emb = torch.empty((2 * num_buckets + 1, num_heads), dtype=torch.float32)
        emb.normal_(0.0, 0.02, generator=generator)
        self.rel_bias = nn.Parameter(emb.to(device))

    def forward(self, T: int):
        pos = torch.arange(T, device=self.rel_bias.device)
        rel = pos[None, :] - pos[:, None]
        idx = rel.clamp(-self.num_buckets, self.num_buckets) + self.num_buckets
        return self.rel_bias[idx].permute(2, 0, 1).contiguous()  # [H, T, T]


class DepthwiseShift(nn.Module):
    """Depthwise 1-D conv (SAME padding) as kernel-tap shifted multiply-adds
    in `dtype`, taps in order 0..K-1, bias last; kernel [K, 1, dim] and bias
    [dim] as a grouped nn.Conv would hold them."""

    def __init__(self, features: int, kernel_size: int, dtype=torch.float32, device=None,
                 generator=None):
        super().__init__()
        self.kernel_size, self.dtype = kernel_size, dtype
        self.kernel = _param((kernel_size, 1, features), device, fan_in=kernel_size,
                             generator=generator)
        self.bias = _param((features,), device)

    def forward(self, x):  # [B, T, C]
        K, T = self.kernel_size, x.shape[1]
        kernel = self.kernel.to(self.dtype)
        lo = (K - 1) // 2
        xp = F.pad(x, (0, 0, lo, K - 1 - lo))
        y = xp[:, 0:T] * kernel[0, 0]
        for k in range(1, K):
            y = y + xp[:, k : k + T] * kernel[k, 0]
        return y + self.bias.to(self.dtype)


class DepthwiseConv(DepthwiseShift):
    """The same depthwise convolution (SAME padding, the same parameters) as
    a grouped convolution over [B, C, T] (`models.cnn.conv`)."""

    def forward(self, x):  # [B, T, C]
        K, dt = self.kernel_size, self.dtype
        lo = (K - 1) // 2
        xp = F.pad(x.transpose(1, 2), (lo, K - 1 - lo))
        y = conv(xp, self.kernel.to(dt).permute(2, 1, 0), (1,), groups=x.shape[-1])
        return y.transpose(1, 2) + self.bias.to(dt)


class Frontend(nn.Module):
    """Strided VALID 1-D convolution over time (kernel [K, F, dim], flax
    nn.Conv layout) in `dtype`, as one matmul over the unfolded windows."""

    def __init__(self, feat_dim, dim, kernel_size, stride, dtype=torch.float32, device=None,
                 generator=None):
        super().__init__()
        self.kernel_size, self.stride, self.dtype = kernel_size, stride, dtype
        self.kernel = _param((kernel_size, feat_dim, dim), device,
                             fan_in=kernel_size * feat_dim, generator=generator)
        self.bias = _param((dim,), device)

    def forward(self, feats):  # [B, T_in, F] -> [B, T_out, dim]
        dt = self.dtype
        K, Fd, dim = self.kernel.shape
        win = feats.to(dt).unfold(1, K, self.stride)  # [B, T_out, F, K]
        win = win.permute(0, 1, 3, 2).reshape(feats.shape[0], -1, K * Fd)
        return win @ self.kernel.to(dt).reshape(K * Fd, dim) + self.bias.to(dt)


class ConformerBlock(nn.Module):
    def __init__(self, cfg: ConformerConfig, device=None, generator=None):
        super().__init__()
        self.cfg = cfg
        D, dt = cfg.dim, cfg.dtype
        Fh = D * cfg.ffn_mult

        def dense(i, o):
            return Dense(i, o, device, generator, dt)

        def ln():
            if cfg.ln_impl == "flax":
                return FlaxLayerNorm(D, device=device)
            return FusedLayerNorm(D, dtype=dt, device=device)

        self.ln_ffn1, self.ffn1_in, self.ffn1_out = ln(), dense(D, Fh), dense(Fh, D)
        self.ln_attn, self.attn_qkv, self.attn_out = ln(), dense(D, 3 * D), dense(D, D)
        self.ln_conv, self.conv_in = ln(), dense(D, 2 * D)
        # the grouped convolution is a float32 island in a bfloat16 trunk
        # whatever depthwise_f32 says, as in the JAX package
        self.dw_dtype = (torch.float32 if cfg.depthwise_f32 or (
            cfg.depthwise_impl == "conv" and dt == torch.bfloat16) else dt)
        dw = DepthwiseConv if cfg.depthwise_impl == "conv" else DepthwiseShift
        self.depthwise = dw(D, cfg.conv_kernel, self.dw_dtype, device, generator)
        self.BatchNorm_0 = batch_norm(D, cfg.bn_impl, device)
        self.conv_out = dense(D, D)
        self.ln_ffn2, self.ffn2_in, self.ffn2_out = ln(), dense(D, Fh), dense(Fh, D)
        self.ln_out = ln()
        #: the model group of each half-step split over it (shard_params)
        self._ffn_split: dict[str, object] = {}

    def split_over_model(self, mesh, axes: dict) -> list[str]:
        """`shard_params`'s question: of this block's sharded leaves (`axes`,
        name -> axis), the ones it computes on as shards: each half-step
        whose W1 is cut by columns and W2 by rows (the rule's cut wherever
        F is the largest axis and the model axis divides it) runs split
        over `mesh`'s model group; its b1 stays whole, used by slices, and
        its gradient is summed over the group after the backward."""
        taken = []
        for k in ("ffn1", "ffn2"):
            if axes.get(f"{k}_in.kernel") == 1 and axes.get(f"{k}_out.kernel") == 0:
                self._ffn_split[k] = mesh
                getattr(self, f"{k}_in").bias.model_grad_sum = mesh
                taken += [f"{k}_in.kernel", f"{k}_out.kernel"]
        return taken

    def _ffn_half(self, h, res, w_in: Dense, w_out: Dense, name: str):
        # half-step FFN: res + 0.5 * (swish(h @ W1 + b1) @ W2 + b2)
        mesh = self._ffn_split.get(name)
        if mesh is not None:
            return self._ffn_half_split(mesh, h, res, w_in, w_out)
        if self.cfg.ffn_impl == "fused":
            return ffn_apply(h, res, whole(w_in.kernel), w_in.bias, whole(w_out.kernel),
                             w_out.bias, 0.5)
        return res + 0.5 * w_out(swish(w_in(h)))

    def _ffn_half_split(self, mesh, h, res, w_in: Dense, w_out: Dense):
        """The half-step on this rank's F / m hidden columns: a float32
        partial summed over the model group, then the residual and b2 added
        once.  The partial and xn's gradient stay float32 until the sums are
        taken, so the split half-step rounds where the whole one does (the
        fused form once, after the residual; the dense form at each
        `Dense`'s output)."""
        dt = self.cfg.dtype
        w1, w2 = w_in.kernel, w_out.kernel
        b1 = w_in.bias.narrow(0, mesh.model_rank * w1.shape[1], w1.shape[1])
        x = to_model_group(mesh, h.float())
        if self.cfg.ffn_impl == "fused":
            part = sum_over_model_group(mesh, ffn_partial(x, w1, b1, w2, 0.5, dt))
            return (res.float() + (part + 0.5 * w_out.bias.float())).to(dt)
        u = (x @ w1.to(dt).float()).to(dt) + b1.to(dt)
        part = sum_over_model_group(mesh, swish(u).float() @ w2.to(dt).float())
        return res + 0.5 * (part.to(dt) + w_out.bias.to(dt))

    def _ln(self, name, x):
        # a float32 normalization island, its output in the trunk dtype
        return getattr(self, name)(x).to(self.cfg.dtype)

    def forward(self, x, bias, train: bool = False):
        cfg = self.cfg
        x = self._ffn_half(self._ln("ln_ffn1", x), x, self.ffn1_in, self.ffn1_out, "ffn1")

        # self-attention with relative position bias
        qkv = self.attn_qkv(self._ln("ln_attn", x))
        dh = cfg.dim // cfg.num_heads
        attention = einsum_attention if cfg.attn_impl == "einsum" else fused_relpos_attention
        att = attention(qkv, bias, cfg.num_heads, 1.0 / math.sqrt(dh))
        x = x + self.attn_out(att)

        # convolution module
        a, b = self.conv_in(self._ln("ln_conv", x)).chunk(2, dim=-1)
        h = a * torch.sigmoid(b)  # GLU
        h = self.depthwise(h.to(self.dw_dtype))
        # float32 batchnorm island (the running statistics are float32)
        h = self.BatchNorm_0(h.float(), train).to(cfg.dtype)
        x = x + self.conv_out(swish(h))

        x = self._ffn_half(self._ln("ln_ffn2", x), x, self.ffn2_in, self.ffn2_out, "ffn2")
        return self._ln("ln_out", x)


class Conformer(nn.Module):
    """Conformer stack with chain + xent heads (float32 outputs)."""

    def __init__(self, cfg: ConformerConfig, feat_dim: int, device="cuda", generator=None):
        super().__init__()
        self.config = cfg
        dt = cfg.dtype
        self.frontend = Frontend(feat_dim, cfg.dim, cfg.frontend_kernel,
                                 cfg.frame_subsampling_factor, dt, device, generator)
        self.rel_pos = RelPositionBias(cfg.num_heads, cfg.rel_pos_buckets, device, generator)
        for i in range(cfg.num_layers):
            setattr(self, f"block{i}", ConformerBlock(cfg, device, generator))
        self.chain_head = Prefinal(cfg.dim, cfg.prefinal_dim, cfg.num_pdfs, device, generator, dt,
                                   cfg.bn_impl)
        self.xent_head = Prefinal(cfg.dim, cfg.prefinal_dim, cfg.num_pdfs, device, generator, dt,
                                  cfg.bn_impl)

    def forward(self, feats, train: bool = False, dropout_rate=None,
                generator: torch.Generator | None = None):
        """feats [B, T_in, F] -> (chain, xent) [B, T_out, num_pdfs].  The
        per-block continuous dropout draws from `generator`; without one
        (or when not training) it is the identity."""
        cfg = self.config
        x = swish(self.frontend(feats))
        bias = self.rel_pos(x.shape[1])
        if dropout_rate is None and cfg.dropout > 0:
            dropout_rate = cfg.dropout
        for i in range(cfg.num_layers):
            x = getattr(self, f"block{i}")(x, bias, train)
            x = continuous_dropout(x, dropout_rate, train, generator)
        return self.chain_head(x, train), self.xent_head(x, train)
