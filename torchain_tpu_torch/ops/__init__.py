"""ops — device-side chain-loss computation.

  device_graphs.py  DeviceSupervision (torch tensors), auto_den_graph
  den_resident.py   denominator forward-backward: kernels K1, K2
  num_scan.py       numerator forward-backward: frame 0, kernels K5, K6
  num_resident.py   numerator steady-frame recursions: kernels K3, K4
  chain_loss.py     the objective, with a custom autograd.Function
  fused_bn.py       train-mode batchnorm with closed-form backward
"""

from torchain_tpu_torch.ops.chain_loss import ChainLossOptions, ChainResults, chain_loss
from torchain_tpu_torch.ops.den_resident import DeviceResidentDenGraph
from torchain_tpu_torch.ops.device_graphs import DeviceSupervision, auto_den_graph

__all__ = [
    "ChainLossOptions",
    "ChainResults",
    "DeviceResidentDenGraph",
    "DeviceSupervision",
    "auto_den_graph",
    "chain_loss",
]
