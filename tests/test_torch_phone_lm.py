"""`graphs.phone_lm.lm_log_prob` of the PyTorch port against the JAX
package's, on the LMs and sentences that tests/test_graphs_oracle.py
scores: the pruned bigram of its `tiny_setup` over its 20 random sentences,
and the unpruned bigram over three sentences.  Host code copied into the
port, so every score is equal exactly, -inf included."""

import math

import numpy as np
import pytest

pytest.importorskip("jax")

import torchain_tpu.graphs as jgraphs
import torchain_tpu_torch.graphs as tgraphs
from torchain_tpu.graphs.phone_lm import lm_log_prob as j_lm_log_prob
from torchain_tpu_torch.graphs.phone_lm import lm_log_prob as t_lm_log_prob


def _tiny_sentences(num_phones=2, seed=0):
    rng = np.random.default_rng(seed)
    return [list(map(int, rng.integers(1, num_phones + 1, size=rng.integers(2, 6))))
            for _ in range(20)]


CASES = {
    "tiny_setup": (_tiny_sentences(), dict(ngram_order=2, num_extra_lm_states=100)),
    "unpruned": ([[1, 2, 1], [1, 2, 2], [2, 1]],
                 dict(ngram_order=2, num_extra_lm_states=10**6)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_lm_log_prob_equals_jax(case):
    sents, opts = CASES[case]
    jlm = jgraphs.estimate_phone_lm(sents, jgraphs.PhoneLmOptions(**opts))
    tlm = tgraphs.estimate_phone_lm(sents, tgraphs.PhoneLmOptions(**opts))
    # the training sentences, then ones the LM cannot give: an unseen phone,
    # the empty sentence (BOS is not final), a sentence cut before its end
    scored = sents + [[3], [], [1, 3, 1], sents[0][:1]]
    got = [t_lm_log_prob(tlm, s) for s in scored]
    want = [j_lm_log_prob(jlm, s) for s in scored]
    assert got == want
    assert all(math.isfinite(v) for v in got[: len(sents)])
    assert got[len(sents)] == float("-inf")
    if case == "unpruned":
        # the oracle test's hand count: p(2|BOS) p(1|2) p(EOS|1)
        assert math.exp(t_lm_log_prob(tlm, [2, 1])) == pytest.approx((1 / 3) * (2 / 4) * (2 / 4),
                                                                      abs=1e-9)
