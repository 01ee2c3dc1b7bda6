"""CNN-TDNN acoustic encoder (torch), port of torchain_tpu/models/cnn.py.

Kaldi's cnn_tdnn chain family (mini_librispeech
local/chain/tuning/run_cnn_tdnn_1a.sh): a 2-D convolutional front end over
the (time x mel-frequency) plane, conv-relu-batchnorm blocks that subsample
the frequency axis as their filters widen, feeding the factored-TDNN stack
of TDNN-F (`models/tdnn.py` `TdnnfLayer`, time-major, fused batchnorm).

Frame-rate contract: the conv blocks run at the input frame rate with VALID
time padding (each consumes time_kernel // 2 frames a side); the TDNN-F
stack then subsamples by frame_subsampling_factor as TdnnfConfig does, so
`context` composes both parts.  Frequency is padded by (freq_kernel - 1) //
2 bins on each side, as the JAX package's nn.Conv padding ((0, 0), (p, p))
does (not flax's "SAME", which would pad 0 before and 1 after at 40 bins
and stride 2): 40 bins step down 40 -> 20 -> 10, and the final [F', C']
plane flattens, frequency major, into the trunk's input.

The convolutions are torch's own (cuDNN on the card) on [B, C, T, F] (the JAX package runs
`lax.conv_general_dilated`, with no Pallas kernel behind it) through
`conv`, which keeps cuDNN's TF32 off for float32 operands in the forward and
in the backward, so the card computes what the CPU does.  Parameters keep
flax's names and shapes (`conv{i}.kernel [kt, kf, in, out]` HWIO,
`conv_bn{i}`, `input_proj.kernel [F'*C', hidden]`, `BatchNorm_0`,
`tdnnf{i}`, the heads), so `convert.params_from_jax` is a renaming.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch
from torch import nn

from torchain_tpu_torch.models.tdnn import (
    Dense,
    Prefinal,
    TdnnfLayer,
    _param,
    batch_norm,
    check_lowerings,
    continuous_dropout,
)


class _Conv(torch.autograd.Function):
    """An N-d convolution (no bias) whose forward and backward run with
    cuDNN's TF32 off: float32 operands are multiplied in float32, as on the
    CPU and in the JAX package on the CPU."""

    @staticmethod
    def forward(ctx, x, w, stride, groups):
        ctx.save_for_backward(x, w)
        ctx.stride, ctx.groups = stride, groups
        with _ieee(x):
            return torch.ops.aten.convolution(x, w, None, stride, [0] * len(stride),
                                              [1] * len(stride), False, [0] * len(stride), groups)

    @staticmethod
    def backward(ctx, go):
        x, w = ctx.saved_tensors
        n = len(ctx.stride)
        with _ieee(x):
            gx, gw, _ = torch.ops.aten.convolution_backward(
                go.contiguous(), x, w, None, ctx.stride, [0] * n, [1] * n, False, [0] * n,
                ctx.groups, [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False])
        return gx, gw, None, None


@contextlib.contextmanager
def _ieee(x):
    """Within: cuDNN's TF32 off where `x` is a float32 CUDA tensor."""
    if not (x.is_cuda and x.dtype == torch.float32):
        yield
        return
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def conv(x: torch.Tensor, weight: torch.Tensor, stride: tuple, groups: int = 1) -> torch.Tensor:
    """VALID convolution of x [B, C_in, *spatial] by weight [C_out, C_in /
    groups, *kernel] (torch's layout), in x's dtype, TF32 off."""
    return _Conv.apply(x, weight, list(stride), groups)


@dataclasses.dataclass(frozen=True)
class CnnTdnnConfig:
    num_pdfs: int = 120
    #: mel bins of the input features (the conv height)
    feat_dim: int = 40
    #: filters per conv block (Kaldi cnn_tdnn_1a: 48,48,64,64,64,128)
    conv_filters: tuple = (48, 48, 64, 64, 64, 128)
    #: frequency stride per block (subsample frequency as filters widen)
    conv_freq_strides: tuple = (1, 1, 2, 1, 1, 2)
    #: time x freq kernel of every block (Kaldi uses 3x3 throughout)
    time_kernel: int = 3
    freq_kernel: int = 3
    # the TDNN-F stack (TdnnfConfig semantics)
    hidden_dim: int = 768
    bottleneck_dim: int = 96
    prefinal_dim: int = 256
    num_tdnnf_layers: int = 9
    subsample_layer: int = 1
    frame_subsampling_factor: int = 3
    dilation: int = 3
    #: compute dtype of the trunk (parameters stay float32)
    dtype: torch.dtype = torch.float32
    time_major: bool = True
    bn_impl: str = "fused"

    def __post_init__(self):
        check_lowerings(self, bn_impl=("fused", "flax"))
        if len(self.conv_filters) != len(self.conv_freq_strides):
            raise ValueError("conv_filters and conv_freq_strides must align")

    def tdnnf_geometry(self) -> list[tuple[int, int]]:
        out = []
        for i in range(self.num_tdnnf_layers):
            if i == 0:
                out.append((1, 1))
            elif i == self.subsample_layer:
                out.append((1, self.frame_subsampling_factor))
            else:
                out.append((self.dilation, 1))
        return out

    @property
    def conv_context(self) -> int:
        """Input frames each conv side consumes (all blocks run before the
        subsampling, at rate 1)."""
        return len(self.conv_filters) * (self.time_kernel // 2)

    @property
    def context(self) -> tuple[int, int]:
        left = right = self.conv_context
        rate = 1
        for d, s in self.tdnnf_geometry():
            left += d * rate
            rate *= s
            right += d * rate
        return left, right

    @property
    def conv_out_dim(self) -> int:
        f = self.feat_dim
        for s in self.conv_freq_strides:
            f = -(-f // s)  # ceil division
        return f * self.conv_filters[-1]


class ConvBlock(nn.Module):
    """One 2-D conv over [B, T, F, C] (flax nn.Conv layout: kernel [kt, kf,
    in, out], bias [out]): VALID in time, `pad` bins each side in
    frequency, frequency stride `freq_stride`; the bias added after the
    convolution, in `dtype`."""

    def __init__(self, in_ch, out_ch, time_kernel, freq_kernel, freq_stride, pad, device=None,
                 generator=None, dtype=torch.float32):
        super().__init__()
        self.freq_stride, self.pad, self.dtype = freq_stride, pad, dtype
        self.kernel = _param((time_kernel, freq_kernel, in_ch, out_ch), device,
                             fan_in=time_kernel * freq_kernel * in_ch, generator=generator)
        self.bias = _param((out_ch,), device)

    def forward(self, x):  # [B, T, F, C] -> [B, T', F', C']
        dt = self.dtype
        x = torch.nn.functional.pad(x.to(dt).permute(0, 3, 1, 2), (self.pad, self.pad))
        y = conv(x, self.kernel.to(dt).permute(3, 2, 0, 1), (1, self.freq_stride))
        return y.permute(0, 2, 3, 1) + self.bias.to(dt)


class CNNTDNN(nn.Module):
    """2-D conv front end + factored-TDNN stack with chain + xent heads
    (float32 outputs)."""

    def __init__(self, cfg: CnnTdnnConfig, feat_dim: int | None = None, device="cuda",
                 generator=None):
        super().__init__()
        if feat_dim is not None and feat_dim != cfg.feat_dim:
            raise ValueError(f"feat_dim {feat_dim} != CnnTdnnConfig.feat_dim {cfg.feat_dim}")
        self.config = cfg
        H, dt = cfg.hidden_dim, cfg.dtype
        pad = (cfg.freq_kernel - 1) // 2
        in_ch = 1
        for i, (nf, fs) in enumerate(zip(cfg.conv_filters, cfg.conv_freq_strides)):
            setattr(self, f"conv{i}", ConvBlock(in_ch, nf, cfg.time_kernel, cfg.freq_kernel, fs,
                                                pad, device, generator, dt))
            setattr(self, f"conv_bn{i}", batch_norm(nf, cfg.bn_impl, device))
            in_ch = nf
        self.input_proj = Dense(cfg.conv_out_dim, H, device, generator, dt)
        self.BatchNorm_0 = batch_norm(H, cfg.bn_impl, device)
        for i, (d, s) in enumerate(cfg.tdnnf_geometry()):
            setattr(self, f"tdnnf{i}", TdnnfLayer(
                H, H, cfg.bottleneck_dim, dilation=d, stride=s, device=device,
                generator=generator, dtype=dt, time_axis=0 if cfg.time_major else 1,
                bn_impl=cfg.bn_impl))
        self.chain_head = Prefinal(H, cfg.prefinal_dim, cfg.num_pdfs, device, generator, dt,
                                   cfg.bn_impl)
        self.xent_head = Prefinal(H, cfg.prefinal_dim, cfg.num_pdfs, device, generator, dt,
                                  cfg.bn_impl)

    def forward(self, feats, train: bool = False, dropout_rate=None, generator=None):
        """feats [B, T_in, feat_dim] -> (chain, xent) [B, T_out, num_pdfs]."""
        cfg = self.config
        x = feats.to(cfg.dtype)[..., None]  # [B, T, F, 1]: time VALID, frequency padded
        for i in range(len(cfg.conv_filters)):
            x = torch.relu(getattr(self, f"conv{i}")(x))
            x = getattr(self, f"conv_bn{i}")(x, train)
        x = x.reshape(x.shape[0], x.shape[1], -1)  # (frequency, channel) -> features
        x = continuous_dropout(x, dropout_rate, train, generator)
        x = torch.relu(self.input_proj(x))
        x = self.BatchNorm_0(x, train)
        if cfg.time_major:
            x = x.transpose(0, 1)
        for i in range(cfg.num_tdnnf_layers):
            x = getattr(self, f"tdnnf{i}")(x, train, dropout_rate, generator)
        if cfg.time_major:
            x = x.transpose(0, 1)
        return self.chain_head(x, train), self.xent_head(x, train)
