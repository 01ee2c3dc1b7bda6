"""The whole step's share of the card's bfloat16 peak: three times the
forward model FLOPs of a step (the trunk's matrix products and attention's
two products, counted from shapes, no recomputation; chainbench/rooflines)
times the window's steps, over the window's seconds, over 989 TFLOP/s."""

from chainbench.rooflines import PEAK_BF16_FLOPS

LAYER = "Train step"
UNIT = "%"
MOVES = "audio_s_per_s"


def read(run):
    w = run["window"]
    return 100.0 * 3.0 * run["sizes"]["flops"] * w["steps"] / w["window_s"] / PEAK_BF16_FLOPS
