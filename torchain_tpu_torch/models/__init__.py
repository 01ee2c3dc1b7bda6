"""models — the TDNN-F and conformer encoders with chain + xent heads."""

from torchain_tpu_torch.models.conformer import Conformer, ConformerConfig
from torchain_tpu_torch.models.tdnn import TDNNF, ChainBatchNorm, TdnnfConfig, continuous_dropout

__all__ = [
    "TDNNF",
    "ChainBatchNorm",
    "Conformer",
    "ConformerConfig",
    "TdnnfConfig",
    "continuous_dropout",
]
