"""data/augment.py of the port (a host NumPy copy) against the JAX
package's on the same inputs: bit for bit, including the exact
reconstruction of a band-limited tone at speeds 0.9 and 1.1 (the analytic
shifted tone within 2e-3 RMS, as tests/test_augment.py holds the JAX
resampler)."""

import numpy as np
import pytest

pytest.importorskip("jax")

from torchain_tpu.data import augment as J
from torchain_tpu_torch.data import augment as T


@pytest.mark.parametrize("speed", [0.9, 1.0, 1.1, 1.25, 0.85])
def test_resample_matches_bit_for_bit(speed):
    x = np.random.default_rng(0).normal(size=3001).astype(np.float32) * 1000
    got, want = T.resample_waveform(x, speed), J.resample_waveform(x, speed)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("speed", [0.9, 1.1])
def test_exact_reconstruction_of_a_band_limited_tone(speed):
    rate = 8000
    n = np.arange(2 * rate)
    x = np.sin(2 * np.pi * 440.0 * n / rate).astype(np.float32)
    y = T.resample_waveform(x, speed)
    np.testing.assert_array_equal(y, J.resample_waveform(x, speed))
    m = np.arange(y.shape[0])
    ref = np.sin(2 * np.pi * 440.0 * (m * speed) / rate)
    body = slice(400, -400)
    assert np.sqrt(np.mean((y[body] - ref[body]) ** 2)) < 2e-3


def test_resample_refuses_what_the_jax_one_refuses():
    for bad, speed in ((np.zeros((2, 3), np.float32), 1.1), (np.zeros(10, np.float32), 0.0)):
        with pytest.raises(ValueError):
            T.resample_waveform(bad, speed)
        with pytest.raises(ValueError):
            J.resample_waveform(bad, speed)
    assert T.resample_waveform(np.zeros(0, np.float32), 1.1).shape == (0,)


@pytest.mark.parametrize("speed,frames", [(0.9, 67), (1.1, 55), (1.1, 12), (0.9, 200)])
def test_perturb_alignment_matches(speed, frames):
    ali = [(3, 9), (1, 1), (4, 22), (2, 6), (5, 3), (1, 19)]
    got = T.perturb_alignment(ali, speed, frames)
    assert got == J.perturb_alignment(ali, speed, frames)
    assert sum(d for _, d in got) == frames
    with pytest.raises(ValueError):
        T.perturb_alignment(ali, speed, 3)


def test_speed_perturb_corpus_and_key_map_match():
    rng = np.random.default_rng(1)
    wavs = {f"u{i}": rng.normal(size=800 + 37 * i).astype(np.float32) for i in range(3)}
    got, want = T.speed_perturb_wavs(wavs), J.speed_perturb_wavs(wavs)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert T.speed_perturb_key_map(list(wavs)) == J.speed_perturb_key_map(list(wavs))
    assert T.SP_FACTORS_3WAY == J.SP_FACTORS_3WAY
    assert [T.sp_key("a", f) for f in (0.9, 1.0, 1.1)] == ["sp0.9-a", "a", "sp1.1-a"]
