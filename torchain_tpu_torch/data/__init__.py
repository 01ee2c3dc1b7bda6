"""data — chunk loading and the synthetic corpus."""

from torchain_tpu_torch.data.loader import (
    ChainBatch,
    ChainDataset,
    E2eChainDataset,
    SyntheticCorpus,
    Utterance,
    synthetic_dataset,
)

__all__ = [
    "ChainBatch",
    "ChainDataset",
    "E2eChainDataset",
    "SyntheticCorpus",
    "Utterance",
    "synthetic_dataset",
]
