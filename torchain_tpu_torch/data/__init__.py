"""data — chunk loading, the synthetic corpus, and merged Kaldi cegs
archives (cegs)."""

from torchain_tpu_torch.data.cegs import (
    CegsDataset,
    KaldiSupervision,
    NnetChainExample,
    NnetChainSupervision,
    NnetIo,
    batches_from_cegs,
    dataset_to_cegs,
    example_to_batch,
    iter_cegs_ark,
    make_chain_example,
    make_e2e_chain_example,
    read_cegs_ark,
    write_cegs_ark,
)
from torchain_tpu_torch.data.loader import (
    ChainBatch,
    ChainDataset,
    E2eChainDataset,
    SyntheticCorpus,
    Utterance,
    synthetic_dataset,
)

__all__ = [
    "CegsDataset",
    "ChainBatch",
    "ChainDataset",
    "E2eChainDataset",
    "KaldiSupervision",
    "NnetChainExample",
    "NnetChainSupervision",
    "NnetIo",
    "SyntheticCorpus",
    "Utterance",
    "batches_from_cegs",
    "dataset_to_cegs",
    "example_to_batch",
    "iter_cegs_ark",
    "make_chain_example",
    "make_e2e_chain_example",
    "read_cegs_ark",
    "synthetic_dataset",
    "write_cegs_ark",
]
