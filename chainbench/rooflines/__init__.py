"""The yardstick: the card's published peaks, the least time a count of
operations and bytes can take (`bound_s`), and the operations and bytes
the algorithms of the chain step need for a cell's inputs.

Peaks (NVIDIA's H100 SXM data sheet, dense, at the full 700 W): 989
TFLOP/s for bfloat16 products on the tensor cores, 67 TFLOP/s float32
outside them, 3.35 TB/s of HBM3.  A count holds whatever implements it:
each input byte read once and each output byte written once, the work
these inputs need and not the most they could.  The peaks and `bound_s`
are copied from the repository's chip_smoke.py (`PEAK_*`, `_bound`), here
where no later change to the program can move them; the attention count is
its K7 count.  The denominator's and the numerator's counts are new, not
chip_smoke.py's: those count what its kernels move, the residual the
forward writes for the backward (ah [T, B, KS] at the program's padded
slots), and the arcs of the program's own expanded graph; these count the
benchmark's graph (distinct arcs, distinct (destination, pdf) pairs), so
that a kernel that keeps less or walks a smaller graph shows its gain.

The trunks' model FLOPs (the matrix products and attention's two products,
forward, counted from shapes; `step_mfu` takes three times that) are in
`chainbench/rooflines/<reference module>.py`.
"""

from __future__ import annotations

import importlib

PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12


def bound_s(flops: float, nbytes: float, peak_flops: float) -> float:
    """The larger of the operations over the peak and the bytes over the
    bandwidth, in seconds."""
    return max(flops / peak_flops, nbytes / PEAK_BYTES)


def den_counts(B: int, T: int, P: int, S: int, nnz: int, live: int) -> tuple:
    """(flops, bytes) of the denominator's forward and backward over B
    sequences of T frames: `nnz` distinct (source, destination, pdf) arcs of
    S states, `live` distinct (destination, pdf) pairs.  Forward: a
    multiply-add an arc and a multiply a pair, every frame; backward: the
    same pull-back and three multiplies a pair for the occupancies.  Bytes:
    the outputs y [B, T, P] read once and the occupancies written once
    (float32), the arcs (a float32 weight, 16-bit source and slot) and the
    initial probabilities read once, log Z written."""
    flops = 4.0 * T * B * nnz + 4.0 * T * B * live
    nbytes = 8.0 * B * T * P + 8.0 * nnz + 4.0 * S + 4.0 * B
    return flops, nbytes


def num_counts(arcs_steady: int, states: int, vocab: int) -> tuple:
    """(flops, bytes) of the numerator's kernels over a batch: the gather of
    each (row, frame)'s distinct pdfs from y (`vocab` of them in all, an
    index and a value each), the steady frames' forward and backward over
    the live arcs (a 16-byte record each: source, destination, local pdf,
    log-weight; 12 operations an arc, 4 a state, 2 a gathered pdf, in the
    log semiring), and the occupancies of the gathered pdfs written."""
    flops = 12.0 * arcs_steady + 4.0 * states + 2.0 * vocab
    nbytes = 12.0 * vocab + 16.0 * arcs_steady
    return flops, nbytes


def attention_counts(B: int, T: int, D: int, H: int) -> tuple:
    """(flops, bytes) of one layer's attention forward and backward with a
    [H, T, T] float32 position bias and bfloat16 q, k, v: the two products
    forward, four backward (dV, dP, dQ, dK), no recomputation; forward reads
    qkv and the bias and writes the output, backward reads qkv, the bias and
    the output's gradient and writes dqkv and the bias's gradient."""
    flops = 12.0 * B * T * T * D
    nbytes = 22.0 * B * T * D + 12.0 * H * T * T
    return flops, nbytes


def model_flops(module: str, model_cfg: dict, B: int, T_in: int, feat_dim: int,
                num_pdfs: int) -> float:
    """Forward model FLOPs of one step (`rooflines/<module>.py`)."""
    mod = importlib.import_module(f"chainbench.rooflines.{module}")
    return mod.forward_flops(model_cfg, B, T_in, feat_dim, num_pdfs)


def heads_flops(B: int, T: int, dim: int, prefinal: int, num_pdfs: int) -> float:
    """The chain and xent heads: dim -> prefinal -> pdfs, each."""
    return 2 * 2.0 * B * T * (dim * prefinal + prefinal * num_pdfs)
