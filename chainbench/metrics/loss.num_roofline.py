"""The numerator kernels' share of their roofline: the least time the live
work these inputs need can take (chainbench/rooflines `num_counts` over the
trimmed numerator graphs' live arcs, states and per-frame pdfs, averaged
over the cell's batches) over the device time of K3-K6 a step.  Nothing is
read where the trace does not hold one launch of each a step."""

from chainbench.rooflines import PEAK_F32_FLOPS, bound_s, num_counts

LAYER = "Loss numerator"
UNIT = "%"
MOVES = "audio_s_per_s"
KERNELS = {"steady_fwd_kernel": 1, "steady_bwd_kernel": 1, "vocab_gather_kernel": 1,
           "vocab_scatter_kernel": 1}


def read(run):
    trace, num = run["trace"], run["sizes"]["num"]
    seconds = 0.0
    for name, per_step in KERNELS.items():
        n, s = trace.matching((name,))
        if n != per_step * trace.steps:
            return None
        seconds += s
    flops, nbytes = num_counts(num["arcs_steady"], num["states"], num["vocab"])
    return 100.0 * bound_s(flops, nbytes, PEAK_F32_FLOPS) / (seconds / trace.steps)
