"""TDNN-F forward FLOPs from shapes: the input affine, each layer's two
factors (two taps each) at that layer's frame count, and the two heads."""

from __future__ import annotations

from chainbench.rooflines import heads_flops


def forward_flops(cfg: dict, B: int, T_in: int, feat_dim: int, num_pdfs: int) -> float:
    H, b = cfg["hidden_dim"], cfg["bottleneck_dim"]
    flops = 2.0 * B * T_in * feat_dim * H
    T = T_in
    for d, s in cfg["layers"]:
        T1 = (T - d - 1) // s + 1
        T2 = T1 - d
        flops += 2 * 2.0 * B * T1 * H * b + 2 * 2.0 * B * T2 * b * H
        T = T2
    return flops + heads_flops(B, T, H, cfg["prefinal_dim"], num_pdfs)
