"""data/features.py of the port against the JAX package's on the same
NumPy inputs (JAX_PLATFORMS=cpu), with a float64 NumPy computation of the
same formula as the yardstick of both.

Tolerance.  Both sides run the filterbank in float32 (pocketfft through
jnp.fft and through torch.fft, which sum in other orders), so each log-mel
value differs from the float64 yardstick by two roundings: of the value
itself (|ref| * eps32) and of the spectrum's amplitude, which float32 holds
to eps32 of the frame's loudest bin, so that a mel bin `depth` nats below
its frame's loudest moves by ~eps32 * exp(depth / 2) in log power.  The
gate is the port's `features.fbank_tolerance`: eps32 * (16 |ref| + 4
exp(depth / 2)), elementwise, against `features.fbank64`, the yardstick
(chip_smoke.py holds the card to the same two); on the synthetic corpus's phone tones (quiet bins ~24 nats
down) the port's CPU filterbank reaches 0.25 of it and the card's is held
to it in chip_smoke.py.  The two packages are also held to each other
within twice TONE_ATOL, the largest deviation the JAX filterbank shows on
these tones (1.3e-3) with a margin.  MFCC (a fixed DCT of the log-mel
values) and CMVN are held to the JAX package within float32 margins.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import torch

from torchain_tpu.data import features as J
from torchain_tpu.data.synth_wav import render_phone_wave as j_render
from torchain_tpu_torch.data import features as T

#: the two packages' log-mel values agree within 2 * TONE_ATOL (see the
#: docstring); on white noise, where no bin is deep, within 2 * NOISE_ATOL
NOISE_ATOL = 1e-4
TONE_ATOL = 3e-3

OPTS = {"16k40": dict(sample_rate=16000, num_mel_bins=40),
        "8k16": dict(sample_rate=8000, num_mel_bins=16)}


def _both(kw):
    return T.FbankOptions(**kw), J.FbankOptions(**kw)


def _held(wave, kw, atol):
    t_opts, j_opts = _both(kw)
    want = T.fbank64(wave, t_opts)
    jax_out = np.asarray(J.fbank(wave, j_opts))
    got = T.fbank(wave, t_opts, device="cpu")
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    got = got.numpy()
    assert got.shape == jax_out.shape == want.shape
    tol = T.fbank_tolerance(want)
    assert (np.abs(jax_out - want) <= tol).all()  # the gate holds the reference too
    assert (np.abs(got - want) <= tol).all()
    np.testing.assert_allclose(got, jax_out, rtol=0, atol=2 * atol)
    return got


@pytest.mark.parametrize("rate", sorted(OPTS))
@pytest.mark.parametrize("window", ["povey", "hamming", "hanning"])
@pytest.mark.parametrize("scale", [1.0, 4000.0], ids=["unit", "int16"])
def test_fbank_of_noise_batched_and_single(rate, window, scale):
    kw = dict(OPTS[rate], window=window)
    rng = np.random.default_rng(sum(map(ord, f"{rate}{window}{scale}")))
    wave = (rng.normal(size=(3, 4321)) * scale).astype(np.float32)
    batched = _held(wave, kw, NOISE_ATOL)
    # a single wave gives its row of the batch, bit for bit
    single = T.fbank(wave[1], T.FbankOptions(**kw), device="cpu").numpy()
    np.testing.assert_array_equal(single, batched[1])


@pytest.mark.parametrize("rate", sorted(OPTS))
def test_fbank_of_the_corpus_tones(rate):
    """The phone tones of the synthetic raw-audio corpus at int16 scale."""
    kw = OPTS[rate]
    sr = kw["sample_rate"]
    rng = np.random.default_rng(3)
    wave = np.concatenate([j_render(q, sr // 10, sr, rng) for q in range(1, 13)])
    out = _held(wave, kw, TONE_ATOL)
    assert out.min() > np.log(1e-10) + 1  # far above the floor at int16 scale


@pytest.mark.parametrize("extra", [-1, 0, 1], ids=["below", "at", "above"])
def test_lengths_around_one_frame(extra):
    t_opts, j_opts = _both(OPTS["8k16"])
    n = t_opts.frame_length + extra
    wave = np.random.default_rng(5).normal(size=(2, n)).astype(np.float32) * 100
    got = T.fbank(wave, t_opts, device="cpu").numpy()
    want = np.asarray(J.fbank(wave, j_opts))
    assert got.shape == want.shape == (2, 0 if extra < 0 else 1, 16)
    assert T.num_frames(n, t_opts) == J.num_frames(n, j_opts)
    np.testing.assert_allclose(got, want, rtol=0, atol=2 * NOISE_ATOL)


def test_frame_length_equal_to_frame_shift():
    kw = dict(sample_rate=8000, num_mel_bins=16, frame_length_ms=10.0, frame_shift_ms=10.0)
    wave = np.random.default_rng(6).normal(size=1234).astype(np.float32) * 300
    got = _held(wave, kw, NOISE_ATOL)
    assert got.shape == (1234 // 80, 16)


def test_host_tables_and_options_match():
    for kw in OPTS.values():
        t_opts, j_opts = _both(kw)
        assert (t_opts.frame_length, t_opts.frame_shift, t_opts.fft_size) == (
            j_opts.frame_length, j_opts.frame_shift, j_opts.fft_size)
        np.testing.assert_array_equal(T.mel_filterbank(t_opts), J.mel_filterbank(j_opts))
        np.testing.assert_array_equal(T.dct_matrix(t_opts), J.dct_matrix(j_opts))
        for w in ("povey", "hamming", "hanning"):
            a, b = _both(dict(kw, window=w))
            np.testing.assert_array_equal(T._window(a), J._window(b))
    with pytest.raises(ValueError, match="window"):
        T.fbank(np.zeros(400, np.float32), T.FbankOptions(window="bogus"), device="cpu")


def test_mfcc_matches():
    t_opts, j_opts = _both(OPTS["16k40"])
    wave = np.random.default_rng(7).normal(size=(2, 5000)).astype(np.float32) * 1000
    got = T.mfcc(wave, t_opts, device="cpu").numpy()
    want = np.asarray(J.mfcc(wave, j_opts))
    assert got.shape == want.shape == (2, 29, 13)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


def test_a_tensor_stays_on_its_device_and_an_array_defaults_to_the_card():
    wave = torch.zeros(800)
    assert T.fbank(wave, T.FbankOptions(sample_rate=8000, num_mel_bins=16)).device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            T.fbank(np.zeros(800, np.float32))


@pytest.mark.parametrize("norm_var", [False, True])
def test_cmvn_matches(norm_var):
    feats = np.random.default_rng(8).normal(size=(2, 37, 16)).astype(np.float32) * 3 + 5
    got = T.cmvn(torch.as_tensor(feats), norm_var=norm_var).numpy()
    want = np.asarray(J.cmvn(feats, norm_var=norm_var))
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)


def test_corpus_cmvn_stats_match_and_apply():
    rng = np.random.default_rng(9)
    utts = [rng.normal(size=(n, 8)).astype(np.float32) * 2 + 1 for n in (11, 30, 7)]
    m_t, s_t = T.compute_cmvn_stats([torch.as_tensor(u) for u in utts])
    m_j, s_j = J.compute_cmvn_stats(utts)
    np.testing.assert_array_equal(m_t, m_j)
    np.testing.assert_array_equal(s_t, s_j)
    with pytest.raises(ValueError, match="no frames"):
        T.compute_cmvn_stats([])
    for norm_var in (False, True):
        got = T.apply_cmvn_stats(torch.as_tensor(utts[1]), m_t, s_t, norm_var).numpy()
        want = np.asarray(J.apply_cmvn_stats(utts[1], m_j, s_j, norm_var))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_append_ivectors_matches():
    rng = np.random.default_rng(10)
    feats = rng.normal(size=(2, 9, 5)).astype(np.float32)
    ivecs = rng.normal(size=(2, 3)).astype(np.float32)
    got = T.append_ivectors(torch.as_tensor(feats), torch.as_tensor(ivecs)).numpy()
    want = np.asarray(J.append_ivectors(feats, ivecs))
    assert got.shape == (2, 9, 8)
    np.testing.assert_array_equal(got, want)
