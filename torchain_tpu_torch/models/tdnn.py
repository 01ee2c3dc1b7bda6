"""TDNN-F and TDNN acoustic encoders (torch), port of
torchain_tpu/models/tdnn.py: TDNN-F under each of the JAX package's
lowerings (`impl` "dot" or "conv", a time-major trunk or not, fused or
stock batchnorm), and the plain TDNN (dilated convolutions with flax's
stock batchnorm).

Behavioral reference: the Kaldi chain recipes' TDNN-F (factored layers with
a semi-orthogonal bottleneck, batchnorm, and scaled bypass connections —
Povey et al. 2018) over [B, T, F] features with VALID context: the loader
supplies exactly `left_context` + `right_context` extra input frames and
one layer strides by frame_subsampling_factor.

`TdnnfConfig.dtype` is the compute dtype of the trunk (float32, or bfloat16
for the production configuration): parameters stay float32 and are cast
where they are used, batchnorm statistics are float32 sums, and the last
Dense of each head runs in float32 on a float32 input, so both outputs are
float32.  The casts are explicit (no autocast), so the CPU and the card do
the same thing.

Parameters keep the JAX package's names and shapes (a width-2 tap kernel
is [2, in, out], a dense kernel [in, out]; batchnorm has scale/bias and the
running mean/var as buffers) so `convert.params_from_jax` is a plain
renaming.  The model returns (chain_out, xent_out): [B, T_out, num_pdfs].
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from torchain_tpu_torch.ops.fused_bn import (
    bn_train,
    brb_bypass_train,
    brb_train,
    rounded_scalar,
)
from torchain_tpu_torch.parallel.mesh import active_mesh, all_reduce_sum

_TRUNC_STD = 0.87962566103423978  # std of a unit normal truncated to [-2, 2]


def lecun_normal_(t: torch.Tensor, fan_in: int, generator=None) -> torch.Tensor:
    """flax's lecun_normal: truncated normal, variance 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    with torch.no_grad():
        return nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std, generator=generator)


def _param(shape, device, fan_in=None, generator=None, fill=0.0):
    # drawn on the CPU (where a CPU generator lives), then moved: the same
    # seed gives the same weights on every device
    t = torch.empty(shape, dtype=torch.float32)
    if fan_in is None:
        t.fill_(fill)
    else:
        lecun_normal_(t, fan_in, generator)
    return nn.Parameter(t.to(device))


class ChainBatchNorm(nn.Module):
    """Batchnorm over all axes but the last (JAX package semantics: biased
    variance clipped at 0, eps 1e-5, running stats updated as
    m * old + (1 - m) * new with m = 0.99)."""

    def __init__(self, C: int, momentum: float = 0.99, eps: float = 1e-5, device=None):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.scale = _param((C,), device, fill=1.0)
        self.bias = _param((C,), device, fill=0.0)
        self.register_buffer("mean", torch.zeros(C, device=device))
        self.register_buffer("var", torch.ones(C, device=device))

    def _update(self, mean, var):
        m = self.momentum
        with torch.no_grad():
            self.mean.mul_(m).add_((1.0 - m) * mean)
            self.var.mul_(m).add_((1.0 - m) * var)

    def _eval_affine(self, dtype):
        rstd = torch.rsqrt(self.var + self.eps)
        a = (rstd * self.scale).to(dtype)
        b = (self.bias - self.mean * rstd * self.scale).to(dtype)
        return a, b

    def forward(self, x, train: bool = False):
        if not train:
            a, b = self._eval_affine(x.dtype)
            return x * a + b
        y, mean, var = bn_train(x, self.scale, self.bias, self.eps)
        self._update(mean, var)
        return y


class FusedPostBN(ChainBatchNorm):
    """The TDNN-F layer tail relu(x + conv_bias) -> batchnorm
    [-> + bypass_scale * bypass] as one op (ops.fused_bn.brb_*)."""

    def forward(self, x, conv_bias, bypass=None, bypass_scale: float = 0.0, train=False):
        if not train:
            h = torch.clamp(x + conv_bias.to(x.dtype), min=0)
            a, b = self._eval_affine(x.dtype)
            y = h * a + b
            if bypass is not None:
                y = y + rounded_scalar(bypass_scale, y.dtype) * bypass.to(y.dtype)
            return y
        if bypass is not None:
            y, mean, var = brb_bypass_train(
                x, conv_bias, self.scale, self.bias, bypass, self.eps, float(bypass_scale)
            )
        else:
            y, mean, var = brb_train(x, conv_bias, self.scale, self.bias, self.eps)
        self._update(mean, var)
        return y


class Dense(nn.Module):
    """y = x @ kernel + bias, kernel [in, out] (flax nn.Dense layout),
    computed in `dtype` (input, kernel and bias are cast to it)."""

    def __init__(self, in_dim, out_dim, device=None, generator=None, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.kernel = _param((in_dim, out_dim), device, fan_in=in_dim, generator=generator)
        self.bias = _param((out_dim,), device)

    def forward(self, x):
        dt = self.dtype
        return x.to(dt) @ self.kernel.to(dt) + self.bias.to(dt)


def continuous_dropout(x, rate, train: bool, generator: torch.Generator | None = None,
                       time_axis: int = 1):
    """Kaldi's dropout-per-dim-continuous (the chain recipes' dropout):
    multiply each channel by a value uniform in [1 - 2p, 1 + 2p], shared
    across time within an utterance.  The expectation is exactly 1, so there
    is no train/eval rescale.  Identity when not training, when `rate` is
    None, or when no generator is given.  Inside a data-parallel step the
    mask is the global batch's (`parallel.data_parallel`), so a sharded
    step draws what the unsharded one does.  `time_axis` names the axis the
    mask is shared over (1 for [B, T, C], 0 for the time-major [T, B, C]).
    The mask is drawn on the generator's device.  `rate` is a float or a
    float32 0-d tensor on x's device (the same bits)."""
    if not train or rate is None or generator is None:
        return x
    shape = list(x.shape)
    shape[time_axis] = 1
    mesh = active_mesh()
    if mesh is None:
        u = torch.rand(shape, generator=generator, device=generator.device)
    else:
        # the global batch's mask, from the same generator state on every
        # rank; this rank keeps its rows
        b_axis = 1 if time_axis == 0 else 0
        rows = shape[b_axis]
        shape[b_axis] = rows * mesh.data
        u = torch.rand(shape, generator=generator, device=generator.device).narrow(
            b_axis, mesh.rank * rows, rows)
    u = (u * 2.0 - 1.0).to(device=x.device, dtype=x.dtype)
    if isinstance(rate, torch.Tensor):
        # a device scalar (a captured step's): the float32 product a Python
        # rate makes, rounded to x's dtype once, with no read on the host
        return x * (1.0 + (u.float() * (2.0 * rate)).to(x.dtype))
    return x * (1.0 + 2.0 * float(rate) * u)


class Prefinal(nn.Module):
    """Kaldi's prefinal-chain / prefinal-xent block: linear bottleneck +
    relu + batchnorm + affine to pdfs.  Always emits float32 (the chain
    loss runs its recursions in float32 whatever the trunk computes in)."""

    def __init__(self, in_dim, dim, num_pdfs, device=None, generator=None,
                 dtype=torch.float32, bn_impl: str = "fused"):
        super().__init__()
        self.Dense_0 = Dense(in_dim, dim, device, generator, dtype)
        self.BatchNorm_0 = batch_norm(dim, bn_impl, device)
        self.Dense_1 = Dense(dim, num_pdfs, device, generator)

    def forward(self, x, train: bool = False):
        x = torch.relu(self.Dense_0(x))
        x = self.BatchNorm_0(x, train)
        return self.Dense_1(x.float())


class _TapDot(nn.Module):
    """A width-2 dilated 1-D conv as two matmuls (kernel [2, in, out]; tap 0
    looks back `dilation` frames) over the time-major [T, B, C] trunk
    (`time_axis` 0) or [B, T, C] (`time_axis` 1).  With `defer_bias` the
    bias is returned unapplied as (y, bias) for the fused batchnorm tail."""

    def __init__(self, in_feat, features, dilation=1, stride=1, use_bias=True,
                 defer_bias=False, device=None, generator=None, dtype=torch.float32,
                 time_axis: int = 0):
        super().__init__()
        self.features, self.dilation, self.stride = features, dilation, stride
        self.defer_bias, self.dtype, self.time_axis = defer_bias, dtype, time_axis
        # fan-in counts the receptive field, like nn.Conv's kernel
        self.kernel = _param((2, in_feat, features), device, fan_in=2 * in_feat,
                             generator=generator)
        self.bias = _param((features,), device) if use_bias else None

    def forward(self, x):
        in_feat = x.shape[-1]
        d, s, ta = self.dilation, self.stride, self.time_axis
        t_out = (x.shape[ta] - d - 1) // s + 1
        kernel = self.kernel.to(self.dtype)
        if ta == 0 and s == 1 and 2 * self.features <= in_feat:
            # narrowing factor: project first, shift the narrow result
            w = x @ kernel.permute(1, 0, 2).reshape(in_feat, 2 * self.features)
            y = w[:t_out, :, : self.features] + w[d:, :, self.features :]
        else:
            def taps(start):
                return x[(slice(None),) * ta + (slice(start, start + (t_out - 1) * s + 1, s),)]

            y = taps(0) @ kernel[0] + taps(d) @ kernel[1]
        if self.bias is None:
            return y
        if self.defer_bias:
            return y, self.bias
        return y + self.bias.to(self.dtype)


class TdnnfLayer(nn.Module):
    """One factored layer: linear (context [-d, 0]) -> bottleneck -> affine
    (context [0, +d]) -> relu -> batchnorm, with a scaled bypass.

    `impl` "dot" runs both factors as `_TapDot`s over the time axis
    `time_axis` (0 for the time-major [T, B, C] trunk, 1 for [B, T, C]);
    with `bn_impl` "fused" the affine's bias is deferred into `FusedPostBN`,
    which runs bias + relu + batchnorm (+ bypass) as one op.  `impl` "conv"
    runs them as VALID convolutions over [B, T, C] (`TdnnConv`, flax's
    nn.Conv layout), the affine adding its own bias before relu and the
    batchnorm.  `bn_impl` "flax" takes `FlaxBatchNorm` in place of the fused
    batchnorm.  All compute the same function."""

    def __init__(self, in_dim, hidden_dim, bottleneck_dim, dilation=1, stride=1,
                 bypass_scale=0.66, device=None, generator=None, dtype=torch.float32,
                 impl: str = "dot", time_axis: int = 0, bn_impl: str = "fused"):
        super().__init__()
        self.dilation, self.stride, self.bypass_scale = dilation, stride, bypass_scale
        self.time_axis = time_axis if impl == "dot" else 1
        self.fuse_post = impl == "dot" and bn_impl == "fused"
        if impl == "dot":
            self.linear_pre = _TapDot(in_dim, bottleneck_dim, dilation, stride, use_bias=False,
                                      device=device, generator=generator, dtype=dtype,
                                      time_axis=time_axis)
            self.affine = _TapDot(bottleneck_dim, hidden_dim, dilation,
                                  defer_bias=self.fuse_post, device=device,
                                  generator=generator, dtype=dtype, time_axis=time_axis)
        else:
            self.linear_pre = TdnnConv(in_dim, bottleneck_dim, 2, dilation, stride, device,
                                       generator, dtype, use_bias=False)
            self.affine = TdnnConv(bottleneck_dim, hidden_dim, 2, dilation, 1, device,
                                   generator, dtype)
        self.BatchNorm_0 = (FusedPostBN(hidden_dim, device=device) if self.fuse_post
                            else batch_norm(hidden_dim, bn_impl, device))

    def forward(self, x, train: bool = False, dropout_rate=None, generator=None):
        ta, d = self.time_axis, self.dilation
        h = self.affine(self.linear_pre(x))
        if self.fuse_post:
            h, cb = h
        # the bypass source: x cropped to align with h (d left from factor 1,
        # d right from factor 2, then the stride)
        crop = x[(slice(None),) * ta + (slice(d, None, self.stride),)].narrow(ta, 0, h.shape[ta])
        has_bypass = crop.shape[-1] == h.shape[-1]
        if self.fuse_post:
            if has_bypass and dropout_rate is None:
                return self.BatchNorm_0(h, cb, crop, self.bypass_scale, train=train)
            # Kaldi's tdnnf-layer order: dropout after the batchnorm, before
            # the scaled bypass joins, so with a rate given (even 0) the
            # bypass add stays outside the fused op
            h = self.BatchNorm_0(h, cb, train=train)
        else:
            h = self.BatchNorm_0(torch.relu(h), train)
        h = continuous_dropout(h, dropout_rate, train, generator, time_axis=ta)
        if has_bypass:
            h = h + rounded_scalar(self.bypass_scale, h.dtype) * crop.to(h.dtype)
        return h


@dataclasses.dataclass(frozen=True)
class TdnnfConfig:
    num_pdfs: int = 120
    hidden_dim: int = 768
    bottleneck_dim: int = 96
    prefinal_dim: int = 256
    num_layers: int = 9
    #: compute dtype of the trunk (parameters stay float32)
    dtype: torch.dtype = torch.float32
    #: layer index that strides by frame_subsampling_factor
    subsample_layer: int = 1
    frame_subsampling_factor: int = 3
    #: dilation per layer after the subsample layer (Kaldi time-stride 3)
    dilation: int = 3
    #: factored-layer lowering: "dot" (two matrix products per factor) or
    #: "conv" (VALID convolutions with the affine's own bias)
    impl: str = "dot"
    #: run the trunk time-major [T, B, C] ("dot" only; "conv" is [B, T, C])
    time_major: bool = True
    #: batchnorm lowering: "fused" (ops.fused_bn) or "flax" (FlaxBatchNorm)
    bn_impl: str = "fused"

    def __post_init__(self):
        check_lowerings(self, impl=("dot", "conv"), bn_impl=("fused", "flax"))

    def layer_geometry(self) -> list[tuple[int, int]]:
        """(dilation, stride) per tdnnf layer."""
        out = []
        for i in range(self.num_layers):
            if i == 0:
                out.append((1, 1))
            elif i == self.subsample_layer:
                out.append((1, self.frame_subsampling_factor))
            else:
                out.append((self.dilation, 1))
        return out

    @property
    def context(self) -> tuple[int, int]:
        left = right = 0
        rate = 1
        for d, s in self.layer_geometry():
            left += d * rate  # factor 1 looks back d (pre-stride rate)
            rate *= s
            right += d * rate  # factor 2 looks ahead d (post-stride rate)
        return left, right


class InputProj(nn.Module):
    """The k=1 input convolution (kernel [1, F, H], flax nn.Conv layout)."""

    def __init__(self, feat_dim, hidden_dim, device=None, generator=None,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.kernel = _param((1, feat_dim, hidden_dim), device, fan_in=feat_dim,
                             generator=generator)
        self.bias = _param((hidden_dim,), device)

    def forward(self, x):
        dt = self.dtype
        return x.to(dt) @ self.kernel[0].to(dt) + self.bias.to(dt)


class TDNNF(nn.Module):
    """Factored TDNN stack with chain + xent heads (float32 outputs)."""

    def __init__(self, cfg: TdnnfConfig, feat_dim: int, device="cuda", generator=None):
        super().__init__()
        self.config = cfg
        H, dt = cfg.hidden_dim, cfg.dtype
        self.time_major = cfg.time_major and cfg.impl == "dot"
        self.input_proj = InputProj(feat_dim, H, device, generator, dt)
        self.BatchNorm_0 = batch_norm(H, cfg.bn_impl, device)
        for i, (d, s) in enumerate(cfg.layer_geometry()):
            setattr(self, f"tdnnf{i}", TdnnfLayer(
                H, H, cfg.bottleneck_dim, dilation=d, stride=s,
                device=device, generator=generator, dtype=dt, impl=cfg.impl,
                time_axis=0 if self.time_major else 1, bn_impl=cfg.bn_impl,
            ))
        self.chain_head = Prefinal(H, cfg.prefinal_dim, cfg.num_pdfs, device, generator, dt,
                                   cfg.bn_impl)
        self.xent_head = Prefinal(H, cfg.prefinal_dim, cfg.num_pdfs, device, generator, dt,
                                  cfg.bn_impl)

    def forward(self, feats, train: bool = False, dropout_rate=None, generator=None):
        """`dropout_rate` (a float, or None for none) is Kaldi's continuous
        dropout after each factored layer's batchnorm; its masks draw from
        `generator` (none given: no dropout)."""
        x = torch.relu(self.input_proj(feats))
        x = self.BatchNorm_0(x, train)
        if self.time_major:
            x = x.transpose(0, 1)  # [B, T, C] -> [T, B, C]
        for i in range(self.config.num_layers):
            x = getattr(self, f"tdnnf{i}")(x, train, dropout_rate, generator)
        if self.time_major:
            x = x.transpose(0, 1)
        return self.chain_head(x, train), self.xent_head(x, train)


class FlaxBatchNorm(nn.Module):
    """flax's stock nn.BatchNorm over all axes but the last, as the plain
    TDNN trunk uses it: float32 statistics (mean, and the variance as
    max(0, E[x^2] - mean^2)), y = (x - mean) * (rsqrt(var + eps) * scale)
    + bias in float32, cast back to the input's dtype; running statistics
    m * old + (1 - m) * new with m = 0.99, eps 1e-5.  Autograd takes the
    backward through the statistics.  Inside a data-parallel step the
    moments are the global batch's (`parallel.data_parallel`)."""

    def __init__(self, C: int, momentum: float = 0.99, eps: float = 1e-5, device=None):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.scale = _param((C,), device, fill=1.0)
        self.bias = _param((C,), device, fill=0.0)
        self.register_buffer("mean", torch.zeros(C, device=device))
        self.register_buffer("var", torch.ones(C, device=device))

    def forward(self, x, train: bool = False):
        xf = x.float()
        if train:
            axes = tuple(range(x.dim() - 1))
            mesh = active_mesh()
            if mesh is None:
                mean = xf.mean(axes)
                msq = torch.square(xf).mean(axes)
            else:
                # the global batch's moments: the sums and the count
                # all-reduced (autograd carries the sum back to every rank)
                C = x.shape[-1]
                n = xf.new_full((1,), float(xf.numel() // C))
                v = all_reduce_sum(mesh, torch.cat([xf.sum(axes), torch.square(xf).sum(axes), n]))
                mean, msq = v[:C] / v[2 * C], v[C:2 * C] / v[2 * C]
            var = torch.clamp(msq - torch.square(mean), min=0.0)
            m = self.momentum
            with torch.no_grad():
                self.mean.mul_(m).add_((1.0 - m) * mean)
                self.var.mul_(m).add_((1.0 - m) * var)
        else:
            mean, var = self.mean, self.var
        y = (xf - mean) * (torch.rsqrt(var + self.eps) * self.scale) + self.bias
        return y.to(x.dtype)


def batch_norm(C: int, impl: str, device=None) -> nn.Module:
    """The batchnorm of a trunk by its lowering (the JAX package's
    `batch_norm` factory): "fused" a ChainBatchNorm, "flax" a FlaxBatchNorm.
    Both hold scale/bias and the running mean/var under the same names."""
    if impl == "fused":
        return ChainBatchNorm(C, device=device)
    if impl == "flax":
        return FlaxBatchNorm(C, device=device)
    raise ValueError(f"bn_impl={impl!r}")


def check_lowerings(cfg, **allowed) -> None:
    """Raise for a config field whose value is not one of its lowerings."""
    for field, values in allowed.items():
        if getattr(cfg, field) not in values:
            raise ValueError(f"{field}={getattr(cfg, field)!r} is not ported"
                             f" (the lowerings are: {', '.join(values)})")


class TdnnConv(nn.Module):
    """A dilated, strided VALID 1-D convolution over [B, T, C] (flax nn.Conv
    layout: kernel [K, in, out], bias [out]) in `dtype`: the K strided time
    slices side by side, times the kernel as one [K*in, out] matrix (one
    rounding of the sum over taps, as a convolution makes it)."""

    def __init__(self, in_feat, features, kernel_size, dilation=1, stride=1, device=None,
                 generator=None, dtype=torch.float32, use_bias: bool = True):
        super().__init__()
        self.kernel_size, self.dilation, self.stride, self.dtype = (
            kernel_size, dilation, stride, dtype)
        self.kernel = _param((kernel_size, in_feat, features), device,
                             fan_in=kernel_size * in_feat, generator=generator)
        self.bias = _param((features,), device) if use_bias else None

    def forward(self, x):
        K, d, s, dt = self.kernel_size, self.dilation, self.stride, self.dtype
        t_out = (x.shape[1] - d * (K - 1) - 1) // s + 1
        x = x.to(dt)
        taps = [x[:, j * d : j * d + (t_out - 1) * s + 1 : s] for j in range(K)]
        y = torch.cat(taps, -1) @ self.kernel.to(dt).reshape(-1, self.kernel.shape[-1])
        return y if self.bias is None else y + self.bias.to(dt)


@dataclasses.dataclass(frozen=True)
class TdnnConfig:
    num_pdfs: int = 120
    hidden_dim: int = 512
    prefinal_dim: int = 256
    #: compute dtype of the trunk (parameters stay float32)
    dtype: torch.dtype = torch.float32
    #: (kernel, dilation, stride) per layer; exactly one stride equals
    #: frame_subsampling_factor
    layers: tuple = ((5, 1, 1), (3, 1, 3), (3, 3, 1), (3, 3, 1), (3, 3, 1))

    @property
    def frame_subsampling_factor(self) -> int:
        f = 1
        for _, _, s in self.layers:
            f *= s
        return f

    @property
    def context(self) -> tuple[int, int]:
        """(left, right) input frames consumed beyond T_out * fsf."""
        left = 0
        rate = 1
        for k, d, s in self.layers:
            left += (k // 2) * d * rate
            rate *= s
        return left, left  # symmetric kernels


class TDNN(nn.Module):
    """Plain TDNN (torchain_tpu/models/tdnn.py `TDNN`): dilated VALID
    convolutions, each followed by relu, flax's batchnorm and continuous
    dropout, then the chain and xent heads (float32 outputs)."""

    def __init__(self, cfg: TdnnConfig, feat_dim: int, device="cuda", generator=None):
        super().__init__()
        self.config = cfg
        in_dim = feat_dim
        for i, (k, d, s) in enumerate(cfg.layers):
            setattr(self, f"tdnn{i}", TdnnConv(in_dim, cfg.hidden_dim, k, d, s, device,
                                               generator, cfg.dtype))
            setattr(self, f"BatchNorm_{i}", FlaxBatchNorm(cfg.hidden_dim, device=device))
            in_dim = cfg.hidden_dim
        H, dt = cfg.hidden_dim, cfg.dtype
        self.chain_head = Prefinal(H, cfg.prefinal_dim, cfg.num_pdfs, device, generator, dt)
        self.xent_head = Prefinal(H, cfg.prefinal_dim, cfg.num_pdfs, device, generator, dt)

    def forward(self, feats, train: bool = False, dropout_rate=None, generator=None):
        x = feats.to(self.config.dtype)
        for i in range(len(self.config.layers)):
            x = torch.relu(getattr(self, f"tdnn{i}")(x))
            x = getattr(self, f"BatchNorm_{i}")(x, train)
            x = continuous_dropout(x, dropout_rate, train, generator)
        return self.chain_head(x, train), self.xent_head(x, train)
