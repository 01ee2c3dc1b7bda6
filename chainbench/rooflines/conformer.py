"""Conformer forward FLOPs from shapes: the strided frontend, each block's
products (two half-step feed-forwards 2 x 2 x 2ND(fD), qkv 6ND^2, the
attention output 2ND^2, the convolution module's 4ND^2 in and 2ND^2 out),
attention's two products 4BT^2D, and the two heads.  The depthwise
convolution is not a matrix product and is not counted."""

from __future__ import annotations

from chainbench.rooflines import heads_flops


def forward_flops(cfg: dict, B: int, T_in: int, feat_dim: int, num_pdfs: int) -> float:
    D, K, s = cfg["dim"], cfg["frontend_kernel"], cfg["frame_subsampling_factor"]
    T = (T_in - K) // s + 1
    N = B * T
    flops = 2.0 * N * K * feat_dim * D
    per_block = (8.0 * N * D * cfg["ffn_mult"] * D + 14.0 * N * D * D
                 + 4.0 * B * T * T * D)
    flops += cfg["num_layers"] * per_block
    return flops + heads_flops(B, T, D, cfg["prefinal_dim"], num_pdfs)
