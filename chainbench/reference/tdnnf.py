"""TDNN-F (Povey et al. 2018, "Semi-Orthogonal Low-Rank Matrix Factorization
for Deep Neural Networks"; Kaldi's tdnnf-layer) in plain PyTorch, float32,
over [B, T_in, F] features with VALID context:

    x = batchnorm(relu(feats W_in + b_in))
    layer i, time-stride d_i and stride s_i:
        h = x[t] A0 + x[t + d] A1                 (linear, to the bottleneck)
        h = h[t] B0 + h[t + d] B1 + b             (affine, back to the width)
        x = batchnorm(relu(h)) + 0.66 * x[d + s t]   (the scaled bypass)
    chain, xent = prefinal(x), prefinal(x)

Parameters by name (`<layer>.kernel` [taps, in, out]); the layer geometry
comes from the configuration's `layers`: (time-stride, stride) pairs.
"""

from __future__ import annotations

import torch

from chainbench.reference.ops import Products, batchnorm, prefinal

BYPASS_SCALE = 0.66


def constrained(names: list) -> list:
    """The parameters Kaldi's semi-orthogonal constraint acts on: each
    factored layer's linear to the bottleneck."""
    return [n for n in names if n.endswith(".linear_pre.kernel")]


def context(model_cfg: dict) -> tuple:
    """(left, right) input frames the layers consume."""
    left = right = 0
    rate = 1
    for d, s in model_cfg["layers"]:
        left += d * rate
        rate *= s
        right += d * rate
    return left, right


def _taps(x, kernel, d: int, s: int, mm: Products):
    t_out = (x.shape[1] - d - 1) // s + 1
    span = (t_out - 1) * s + 1
    return mm(x[:, 0:span:s], kernel[0]) + mm(x[:, d:d + span:s], kernel[1])


def forward(p: dict, feats: torch.Tensor, model_cfg: dict, mm: Products):
    """(chain, xent) [B, T_out, P] of feats [B, T_in, F]."""
    x = torch.relu(mm(feats, p["input_proj.kernel"][0]) + p["input_proj.bias"])
    x = batchnorm(x, p["BatchNorm_0.scale"], p["BatchNorm_0.bias"])
    for i, (d, s) in enumerate(model_cfg["layers"]):
        n = f"tdnnf{i}"
        h = _taps(x, p[f"{n}.linear_pre.kernel"], d, s, mm)
        h = _taps(h, p[f"{n}.affine.kernel"], d, 1, mm) + p[f"{n}.affine.bias"]
        h = batchnorm(torch.relu(h), p[f"{n}.BatchNorm_0.scale"], p[f"{n}.BatchNorm_0.bias"])
        crop = x[:, d::s][:, :h.shape[1]]
        x = h + BYPASS_SCALE * crop
    return prefinal(p, "chain_head", x, mm), prefinal(p, "xent_head", x, mm)
