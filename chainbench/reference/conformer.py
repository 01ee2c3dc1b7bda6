"""Conformer (Gulati et al. 2020, arXiv:2005.08100) in plain PyTorch,
float32, with the departures of the configuration: a strided VALID
convolution in front for the chain frame rate, and a T5-style bucketed
relative position bias shared by the blocks.

    x = swish(conv_frontend(feats))
    block:  x = x + 0.5 ffn(ln(x))
            x = x + attn(ln(x)) W_o            (softmax(q k^T / sqrt(dh) + bias) v)
            x = x + W_out swish(bn(depthwise(glu(ln(x) W_in))))
            x = x + 0.5 ffn(ln(x)),  x = ln(x)
    ffn(h) = swish(h W1 + b1) W2 + b2
    chain, xent = prefinal(x), prefinal(x)

The depthwise convolution pads SAME, (K - 1) // 2 frames on the left.
"""

from __future__ import annotations

import math

import torch
from torch.nn import functional as F

from chainbench.reference.ops import Products, batchnorm, layernorm, prefinal, swish


def context(model_cfg: dict) -> tuple:
    c = (model_cfg["frontend_kernel"] - 1) // 2
    return c, c


def _dense(p, name, x, mm):
    return mm(x, p[f"{name}.kernel"]) + p[f"{name}.bias"]


def _ln(p, name, x):
    return layernorm(x, p[f"{name}.scale"], p[f"{name}.bias"])


def _attention(qkv, bias, heads: int, mm: Products):
    B, T, D3 = qkv.shape
    D = D3 // 3
    q, k, v = (qkv[..., i * D:(i + 1) * D].reshape(B, T, heads, D // heads).transpose(1, 2)
               for i in range(3))
    logits = mm(q, k.transpose(-1, -2)) / math.sqrt(D // heads) + bias
    out = mm(torch.softmax(logits, dim=-1), v)
    return out.transpose(1, 2).reshape(B, T, D)


def _block(p, n, x, bias, cfg, mm):
    x = x + 0.5 * _dense(p, f"{n}.ffn1_out", swish(_dense(p, f"{n}.ffn1_in",
                                                         _ln(p, f"{n}.ln_ffn1", x), mm)), mm)
    qkv = _dense(p, f"{n}.attn_qkv", _ln(p, f"{n}.ln_attn", x), mm)
    x = x + _dense(p, f"{n}.attn_out", _attention(qkv, bias, cfg["num_heads"], mm), mm)
    a, b = _dense(p, f"{n}.conv_in", _ln(p, f"{n}.ln_conv", x), mm).chunk(2, dim=-1)
    h = a * torch.sigmoid(b)
    K = cfg["conv_kernel"]
    lo = (K - 1) // 2
    hp = F.pad(h, (0, 0, lo, K - 1 - lo))
    kernel = p[f"{n}.depthwise.kernel"]
    T = h.shape[1]
    h = sum(hp[:, k:k + T] * kernel[k, 0] for k in range(K)) + p[f"{n}.depthwise.bias"]
    h = batchnorm(h, p[f"{n}.BatchNorm_0.scale"], p[f"{n}.BatchNorm_0.bias"])
    x = x + _dense(p, f"{n}.conv_out", swish(h), mm)
    x = x + 0.5 * _dense(p, f"{n}.ffn2_out", swish(_dense(p, f"{n}.ffn2_in",
                                                         _ln(p, f"{n}.ln_ffn2", x), mm)), mm)
    return _ln(p, f"{n}.ln_out", x)


def forward(p: dict, feats: torch.Tensor, model_cfg: dict, mm: Products):
    """(chain, xent) [B, T_out, P] of feats [B, T_in, F]."""
    K = model_cfg["frontend_kernel"]
    stride = model_cfg["frame_subsampling_factor"]
    kernel = p["frontend.kernel"]
    win = feats.unfold(1, K, stride).permute(0, 1, 3, 2).reshape(feats.shape[0], -1,
                                                                 K * feats.shape[-1])
    x = swish(mm(win, kernel.reshape(-1, kernel.shape[-1])) + p["frontend.bias"])
    T = x.shape[1]
    nb = model_cfg["rel_pos_buckets"]
    pos = torch.arange(T, device=x.device)
    idx = (pos[None, :] - pos[:, None]).clamp(-nb, nb) + nb
    bias = p["rel_pos.rel_bias"][idx].permute(2, 0, 1)
    for i in range(model_cfg["num_layers"]):
        x = _block(p, f"block{i}", x, bias, model_cfg, mm)
    return prefinal(p, "chain_head", x, mm), prefinal(p, "xent_head", x, mm)
