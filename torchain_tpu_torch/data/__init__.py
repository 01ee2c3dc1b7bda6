"""data — chunk loading, the synthetic phone and word corpora, merged Kaldi
cegs archives (cegs), and Kaldi symbol tables (kaldi_compat)."""

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
from torchain_tpu_torch.data.words import (
    WordCorpus,
    random_lexicon,
    synthetic_word_dataset,
    train_word_lm,
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
    "WordCorpus",
    "batches_from_cegs",
    "dataset_to_cegs",
    "example_to_batch",
    "iter_cegs_ark",
    "make_chain_example",
    "make_e2e_chain_example",
    "random_lexicon",
    "read_cegs_ark",
    "synthetic_dataset",
    "synthetic_word_dataset",
    "train_word_lm",
    "write_cegs_ark",
]
