"""models — the TDNN-F encoder with chain + xent heads."""

from torchain_tpu_torch.models.tdnn import TDNNF, ChainBatchNorm, TdnnfConfig

__all__ = ["TDNNF", "ChainBatchNorm", "TdnnfConfig"]
