"""data — feature extraction (features: fbank, MFCC, CMVN on a torch
device), the raw-audio front (augment: speed perturbation; ivector: online
i-vectors; synth_wav: a synthetic raw-audio data dir), chunk loading with
its egs cache (loader), batches materialized once (materialize), the
synthetic phone and word corpora, merged Kaldi cegs archives (cegs), and
Kaldi data directories (kaldi_compat: symbol tables, features, alignments,
speakers, CMVN, wav files).

The names of data/features.py and data/synth_wav.py (which import torch)
are loaded where first used (module `__getattr__`), so that importing a
host module of this package (kaldi_compat, cegs, loader, for the host
tools) imports neither the feature front nor torch.
"""

from torchain_tpu_torch.data.augment import (
    perturb_alignment,
    resample_waveform,
    speed_perturb_wavs,
)
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
from torchain_tpu_torch.data.ivector import (
    DiagUbm,
    IvectorExtractor,
    append_corpus_ivectors,
    extract_ivector,
    extract_ivectors_online,
    train_diag_ubm,
    train_ivector_extractor,
)
from torchain_tpu_torch.data.kaldi_compat import (
    apply_cmvn_by_speaker,
    apply_cmvn_stats_matrix,
    cmvn_stats_from_feats,
    compute_cmvn_stats_per_spk,
    compute_feats_from_wav_scp,
    extract_utterance_waves,
    load_kaldi_dir,
    load_wav_dir,
    read_segments,
    read_utt2spk,
    read_wav,
    read_wav_scp,
    spk2utt_from_utt2spk,
    write_utt2spk,
    write_wav,
)
from torchain_tpu_torch.data.loader import (
    ChainBatch,
    ChainDataset,
    E2eChainDataset,
    SyntheticCorpus,
    Utterance,
    synthetic_dataset,
)
from torchain_tpu_torch.data.materialize import MaterializedBatches, PlacedBatch
from torchain_tpu_torch.data.prefetch import Prefetcher
from torchain_tpu_torch.data.words import (
    WordCorpus,
    random_lexicon,
    synthetic_word_dataset,
    train_word_lm,
)

#: name -> module of the names loaded where first used
_LAZY = {
    "FbankOptions": "features",
    "apply_cmvn_stats": "features",
    "append_ivectors": "features",
    "cmvn": "features",
    "compute_cmvn_stats": "features",
    "fbank": "features",
    "mfcc": "features",
    "make_wav_data_dir": "synth_wav",
}


def __getattr__(name: str):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(f"{__name__}.{_LAZY[name]}"), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "CegsDataset",
    "ChainBatch",
    "ChainDataset",
    "DiagUbm",
    "E2eChainDataset",
    "FbankOptions",
    "IvectorExtractor",
    "KaldiSupervision",
    "MaterializedBatches",
    "NnetChainExample",
    "NnetChainSupervision",
    "NnetIo",
    "PlacedBatch",
    "Prefetcher",
    "SyntheticCorpus",
    "Utterance",
    "WordCorpus",
    "append_corpus_ivectors",
    "append_ivectors",
    "apply_cmvn_by_speaker",
    "apply_cmvn_stats",
    "apply_cmvn_stats_matrix",
    "batches_from_cegs",
    "cmvn",
    "cmvn_stats_from_feats",
    "compute_cmvn_stats",
    "compute_cmvn_stats_per_spk",
    "compute_feats_from_wav_scp",
    "dataset_to_cegs",
    "example_to_batch",
    "extract_ivector",
    "extract_ivectors_online",
    "extract_utterance_waves",
    "fbank",
    "iter_cegs_ark",
    "load_kaldi_dir",
    "load_wav_dir",
    "make_chain_example",
    "make_e2e_chain_example",
    "make_wav_data_dir",
    "mfcc",
    "perturb_alignment",
    "random_lexicon",
    "read_cegs_ark",
    "read_segments",
    "read_utt2spk",
    "read_wav",
    "read_wav_scp",
    "resample_waveform",
    "speed_perturb_wavs",
    "spk2utt_from_utt2spk",
    "synthetic_dataset",
    "synthetic_word_dataset",
    "train_diag_ubm",
    "train_ivector_extractor",
    "train_word_lm",
    "write_cegs_ark",
    "write_utt2spk",
    "write_wav",
]
