"""data — chunk loading and the synthetic corpus."""

from torchain_tpu_torch.data.loader import (
    ChainBatch,
    ChainDataset,
    SyntheticCorpus,
    Utterance,
    synthetic_dataset,
)

__all__ = [
    "ChainBatch",
    "ChainDataset",
    "SyntheticCorpus",
    "Utterance",
    "synthetic_dataset",
]
