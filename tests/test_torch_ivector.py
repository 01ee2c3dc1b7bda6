"""data/ivector.py of the port (a host NumPy copy, float64) against the JAX
package's on the same inputs: the UBM, the extractor's matrices and mean
offset, and every extracted i-vector to rel 1e-12 (the same float64
operations in the same order give the same bits; the margin covers BLAS
builds that block a product differently), and the corpus helper's
features bit for bit."""

import numpy as np
import pytest

pytest.importorskip("jax")

from torchain_tpu.data import ivector as J
from torchain_tpu_torch.data import ivector as T

RTOL = 1e-12


def _close(a, b):
    np.testing.assert_allclose(a, b, rtol=RTOL, atol=RTOL * max(1.0, float(np.abs(b).max())))


def _corpus(rng, g=4, f=5, d=3, num_utts=12, frames=60):
    means = rng.normal(scale=4.0, size=(g, f))
    m_true = rng.normal(size=(g, f, d))
    utts = []
    for _ in range(num_utts):
        w = rng.normal(size=d)
        comp = rng.integers(0, g, size=frames)
        utts.append(means[comp] + np.einsum("tfd,d->tf", m_true[comp], w)
                    + 0.3 * rng.normal(size=(frames, f)))
    return utts


def test_ubm_extractor_and_extraction_match():
    rng = np.random.default_rng(0)
    utts = _corpus(rng)
    pool = np.concatenate(utts)
    ubm_t = T.train_diag_ubm(pool, num_gauss=4, num_iters=8, seed=1)
    ubm_j = J.train_diag_ubm(pool, num_gauss=4, num_iters=8, seed=1)
    for k in ("weights", "means", "vars"):
        _close(getattr(ubm_t, k), getattr(ubm_j, k))
    _close(ubm_t.log_likes(utts[0]), ubm_j.log_likes(utts[0]))
    _close(ubm_t.posteriors(utts[0]), ubm_j.posteriors(utts[0]))
    ext_t = T.train_ivector_extractor(ubm_t, utts, 3, num_iters=3, seed=2)
    ext_j = J.train_ivector_extractor(ubm_j, utts, 3, num_iters=3, seed=2)
    _close(ext_t.m, ext_j.m)
    _close(ext_t.mean_offset, ext_j.mean_offset)
    for u in utts[:3]:
        _close(T.extract_ivector(ext_t, u), J.extract_ivector(ext_j, u))
        for kw in (dict(), dict(period=7, posterior_scale=1.0, max_count=0.0),
                   dict(period=5, max_count=5.0)):
            _close(T.extract_ivectors_online(ext_t, u, **kw),
                   J.extract_ivectors_online(ext_j, u, **kw))


def test_ubm_refuses_too_few_frames():
    with pytest.raises(ValueError, match="frames"):
        T.train_diag_ubm(np.zeros((3, 2)), num_gauss=4)


def test_append_corpus_ivectors_matches():
    from torchain_tpu.data import synthetic_dataset as j_synth
    from torchain_tpu_torch.data import Utterance, synthetic_dataset

    corpus = synthetic_dataset(num_utts=6, num_phones=5, feat_dim=8,
                               utt_frames_out=(20, 24), seed=0)
    jcorpus = j_synth(num_utts=6, num_phones=5, feat_dim=8, utt_frames_out=(20, 24), seed=0)
    kw = dict(ivector_dim=3, num_gauss=4, period=5, ubm_frames=300, seed=4)
    got, ext_t = T.append_corpus_ivectors(corpus.utts, **kw)
    want, ext_j = J.append_corpus_ivectors(jcorpus.utts, **kw)
    _close(ext_t.m, ext_j.m)
    assert all(isinstance(u, Utterance) for u in got)
    for a, b in zip(got, want):
        assert a.utt_id == b.utt_id and a.alignment == b.alignment
        assert a.feats.dtype == b.feats.dtype == np.float32
        np.testing.assert_array_equal(a.feats, b.feats)
