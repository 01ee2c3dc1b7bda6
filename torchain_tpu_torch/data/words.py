"""Synthetic word-level corpus: lexicon + word transcripts over the phone
corpus machinery — the fixture for exercising the word decode stack
(graphs/hclg.py) end to end, standing in for the reference recipe's real
corpus + lexicon (SURVEY.md section 3.4: latgen-faster-mapped over HCLG with
word-level WER scoring).  A copy of torchain_tpu/data/words.py: for the same
seed it draws the same lexicon, transcripts and features."""

from __future__ import annotations

import dataclasses

import numpy as np

from torchain_tpu_torch.data.loader import SyntheticCorpus, Utterance
from torchain_tpu_torch.fstkit import Fst
from torchain_tpu_torch.graphs.hclg import Lexicon


@dataclasses.dataclass
class WordCorpus:
    corpus: SyntheticCorpus  # phone-level corpus (training is word-agnostic)
    lexicon: Lexicon
    transcripts: list[list[int]]  # word ids per utterance (aligned with utts)


def random_lexicon(
    vocab_size: int,
    num_phones: int,
    rng: np.random.Generator,
    max_pron_len: int = 4,
    homophones: bool = False,
) -> Lexicon:
    """Random pronunciations, unique across words unless `homophones`."""
    prons: dict[int, list[tuple[int, ...]]] = {}
    used: set[tuple[int, ...]] = set()
    for w in range(1, vocab_size + 1):
        for _ in range(200):
            L = int(rng.integers(1, max_pron_len + 1))
            pron = tuple(int(x) for x in rng.integers(1, num_phones + 1, size=L))
            if homophones or pron not in used:
                used.add(pron)
                prons[w] = [pron]
                break
        else:
            raise ValueError("could not draw a unique pronunciation")
    return Lexicon(prons=prons)


def synthetic_word_dataset(
    num_utts: int = 32,
    vocab_size: int = 20,
    num_phones: int = 8,
    feat_dim: int = 24,
    words_per_utt: tuple[int, int] = (3, 8),
    frame_subsampling_factor: int = 3,
    context_width: int = 1,
    noise: float = 0.5,
    seed: int = 0,
    lm_order: int = 2,
    lm_extra_states: int = 200,
    homophones: bool = False,
) -> WordCorpus:
    """Sentences are word sequences; each word expands through its
    pronunciation into the phone/alignment/feature machinery of
    synthetic_dataset (same generative pdf-mean model), so the training
    side is unchanged while transcripts carry word ids for WER scoring."""
    from torchain_tpu_torch.data.loader import synthetic_dataset

    rng = np.random.default_rng(seed)
    lexicon = random_lexicon(vocab_size, num_phones, rng, homophones=homophones)
    transcripts = [
        [int(w) for w in rng.integers(1, vocab_size + 1, size=int(rng.integers(*words_per_utt)))]
        for _ in range(num_utts)
    ]
    # build the phone-level corpus on the words' phone expansions by reusing
    # synthetic_dataset's generative model: we re-synthesize with the same
    # machinery but provided sentences
    corpus = synthetic_dataset(
        num_utts=num_utts,
        num_phones=num_phones,
        feat_dim=feat_dim,
        frame_subsampling_factor=frame_subsampling_factor,
        context_width=context_width,
        noise=noise,
        seed=seed,
        lm_order=lm_order,
        lm_extra_states=lm_extra_states,
        sentences=[
            [q for w in tr for q in lexicon.prons[w][0]] for tr in transcripts
        ],
    )
    return WordCorpus(corpus=corpus, lexicon=lexicon, transcripts=transcripts)


def train_word_lm(
    transcripts: list[list[int]],
    order: int = 2,
    extra_states: int = 500,
) -> Fst:
    """Word grammar G: the same truncation n-gram estimator as the phone LM
    (graphs/phone_lm.py), trained on word-id sequences."""
    from torchain_tpu_torch.graphs import PhoneLmOptions, estimate_phone_lm

    return estimate_phone_lm(
        transcripts,
        PhoneLmOptions(ngram_order=order, num_extra_lm_states=extra_states),
    )
