"""The denominator kernels' share of their roofline: the least time the
forward-backward these inputs need can take (chainbench/rooflines
`den_counts` at float32's peak, the benchmark's own count: no residual
between the two passes, the benchmark's graph) over the device time of K1
and K2 a step.
Nothing is read where the trace does not hold one launch of each a step."""

from chainbench.rooflines import PEAK_F32_FLOPS, bound_s, den_counts

LAYER = "Loss denominator"
UNIT = "%"
MOVES = "audio_s_per_s"
#: kernel name -> launches a step
KERNELS = {"den_fwd_kernel": 1, "den_bwd_kernel": 1}


def read(run):
    trace, z = run["trace"], run["sizes"]
    seconds = 0.0
    for name, per_step in KERNELS.items():
        n, s = trace.matching((name,))
        if n != per_step * trace.steps:
            return None
        seconds += s
    flops, nbytes = den_counts(z["B"], z["T"], z["P"], z["S"], z["nnz"], z["live"])
    return 100.0 * bound_s(flops, nbytes, PEAK_F32_FLOPS) / (seconds / trace.steps)
