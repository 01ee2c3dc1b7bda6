"""ops — device-side chain-loss computation.

  device_graphs.py  DeviceSupervision, DeviceDenseDenGraph, DeviceDenGraph
                    (torch tensors), auto_den_graph
  den_resident.py   denominator on the slot-dense graph: kernels K1, K2
  den_debruijn.py   denominator on the de Bruijn lift, gather-free (no kernel)
  den_dense.py      denominator on the dense Moore graph: matrix products
  den_pallas.py     the same, fused: kernels K9f, K9b
  den_table.py      denominator over padded in/out-arc tables (no kernel)
  den_scan.py       denominator over sparse arcs, log semiring, and its
                    alpha-checkpointed variant (no kernel)
  num_scan.py       numerator forward-backward: frame 0, kernels K5, K6
  num_resident.py   numerator recursions: kernels K3, K4 (steady frames)
                    and K8f, K8b (flat-start graphs)
  num_e2e.py        flat-start (e2e) numerator: DeviceE2eSupervision
  chain_loss.py     the objective, with a custom autograd.Function
  fused_bn.py       train-mode batchnorm with closed-form backward
  fused_ln.py       LayerNorm with closed-form backward
  attention.py      relative-position attention: kernels K7f, K7b
  fused_ffn.py      conformer feed-forward half-step: kernels K10f, K10b
"""

from torchain_tpu_torch.ops.attention import fused_relpos_attention, reference_relpos_attention
from torchain_tpu_torch.ops.chain_loss import ChainLossOptions, ChainResults, chain_loss
from torchain_tpu_torch.ops.den_debruijn import DeviceDeBruijnDenGraph
from torchain_tpu_torch.ops.den_resident import DeviceResidentDenGraph
from torchain_tpu_torch.ops.den_table import DeviceDenTableGraph
from torchain_tpu_torch.ops.device_graphs import (
    DeviceDenGraph,
    DeviceDenseDenGraph,
    DeviceSupervision,
    auto_den_graph,
)
from torchain_tpu_torch.ops.fused_ffn import ffn_apply
from torchain_tpu_torch.ops.fused_ln import ln_apply
from torchain_tpu_torch.ops.num_e2e import DeviceE2eSupervision

__all__ = [
    "ChainLossOptions",
    "ChainResults",
    "DeviceDeBruijnDenGraph",
    "DeviceDenGraph",
    "DeviceDenTableGraph",
    "DeviceDenseDenGraph",
    "DeviceE2eSupervision",
    "DeviceResidentDenGraph",
    "DeviceSupervision",
    "auto_den_graph",
    "chain_loss",
    "ffn_apply",
    "fused_relpos_attention",
    "ln_apply",
    "reference_relpos_attention",
]
