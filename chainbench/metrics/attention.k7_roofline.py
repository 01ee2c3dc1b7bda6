"""The attention kernels' share of their roofline: the least time the
layers' attention forward and backward can take (chainbench/rooflines
`attention_counts` at bfloat16's peak, times the layers) over the device
time of K7f and K7b's three kernels a step.  Nothing is read where the
trace does not hold one launch of each a layer and step."""

from chainbench.rooflines import PEAK_BF16_FLOPS, attention_counts, bound_s

LAYER = "Attention"
UNIT = "%"
MOVES = "audio_s_per_s"
#: kernel name -> launches a layer and step
KERNELS = {"attn_fwd_kernel": 1, "attn_bwd_rows_kernel": 1, "attn_bwd_cols_kernel": 1,
           "dbias_reduce_kernel": 1}


def read(run):
    trace, z = run["trace"], run["sizes"]
    cfg = run["session"].cell.config["reference"]
    layers = cfg["num_layers"]
    seconds = 0.0
    for name, per_layer in KERNELS.items():
        n, s = trace.matching((name,))
        if n != per_layer * layers * trace.steps:
            return None
        seconds += s
    flops, nbytes = attention_counts(z["B"], z["T"], cfg["dim"], cfg["num_heads"])
    bound = layers * bound_s(flops, nbytes, PEAK_BF16_FLOPS)
    return 100.0 * bound / (seconds / trace.steps)
