"""Filterbank / MFCC feature extraction in PyTorch, port of
torchain_tpu/data/features.py.

Behavioral reference: Kaldi's compute-fbank-feats / compute-mfcc-feats
(kaldi/src/feat/): 25 ms povey-windowed frames every 10 ms, preemphasis
0.97, power spectrum, mel filterbank, log (DCT for MFCC), per-utterance
CMVN.  Batched tensor ops: the mel filterbank, DCT matrix and window are
built on the host in NumPy once, then applied on the wave's device
(`torch.fft.rfft`, `torch.matmul`).

A tensor stays on its device; a NumPy array goes to `device`, the card
unless the caller passes another (the tests pass "cpu").  cuFFT and
pocketfft sum in other orders, so the card's log-mel features differ from
the CPU's by float32 rounding: both are held to `fbank64`, a float64
NumPy computation of the same formula, within `fbank_tolerance`
(tests/test_torch_features.py on the CPU, chip_smoke.py on the card).
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class FbankOptions:
    sample_rate: int = 16000
    frame_length_ms: float = 25.0
    frame_shift_ms: float = 10.0
    num_mel_bins: int = 40
    num_ceps: int = 13  # MFCC only
    low_freq: float = 20.0
    high_freq: float = 0.0  # 0/negative = nyquist + high_freq
    preemphasis: float = 0.97
    dither: float = 0.0
    window: str = "povey"  # povey | hamming | hanning

    @property
    def frame_length(self) -> int:
        return int(self.sample_rate * self.frame_length_ms / 1000)

    @property
    def frame_shift(self) -> int:
        return int(self.sample_rate * self.frame_shift_ms / 1000)

    @property
    def fft_size(self) -> int:
        n = 1
        while n < self.frame_length:
            n *= 2
        return n


def _mel(freq):
    return 1127.0 * np.log1p(np.asarray(freq) / 700.0)


def mel_filterbank(opts: FbankOptions) -> np.ndarray:
    """[fft_size//2+1, num_mel_bins] triangular mel filterbank (host)."""
    nyquist = opts.sample_rate / 2.0
    high = nyquist + opts.high_freq if opts.high_freq <= 0 else opts.high_freq
    n_bins = opts.fft_size // 2 + 1
    mel_lo, mel_hi = _mel(opts.low_freq), _mel(high)
    centers = np.linspace(mel_lo, mel_hi, opts.num_mel_bins + 2)
    freqs = np.linspace(0, nyquist, n_bins)
    mels = _mel(freqs)
    fb = np.zeros((n_bins, opts.num_mel_bins), dtype=np.float32)
    for m in range(opts.num_mel_bins):
        left, center, right = centers[m], centers[m + 1], centers[m + 2]
        up = (mels - left) / (center - left)
        down = (right - mels) / (right - center)
        fb[:, m] = np.maximum(0.0, np.minimum(up, down))
    return fb


def dct_matrix(opts: FbankOptions) -> np.ndarray:
    """[num_mel_bins, num_ceps] orthonormal DCT-II (host)."""
    n, k = opts.num_mel_bins, opts.num_ceps
    mat = np.zeros((n, k), dtype=np.float32)
    for j in range(k):
        scale = math.sqrt((1.0 if j == 0 else 2.0) / n)
        mat[:, j] = scale * np.cos(math.pi * j * (np.arange(n) + 0.5) / n)
    return mat


def _window(opts: FbankOptions) -> np.ndarray:
    n = opts.frame_length
    a = 2 * math.pi / (n - 1)
    i = np.arange(n)
    if opts.window == "povey":
        return (0.5 - 0.5 * np.cos(a * i)) ** 0.85
    if opts.window == "hamming":
        return 0.54 - 0.46 * np.cos(a * i)
    if opts.window == "hanning":
        return 0.5 - 0.5 * np.cos(a * i)
    raise ValueError(f"unknown window {opts.window}")


def num_frames(num_samples: int, opts: FbankOptions) -> int:
    if num_samples < opts.frame_length:
        return 0
    return 1 + (num_samples - opts.frame_length) // opts.frame_shift


@functools.lru_cache(maxsize=32)
def _host_tables(opts: FbankOptions) -> tuple[np.ndarray, np.ndarray]:
    """(window float32 [L], mel bank float32 [fft_size//2+1, M]), built once
    per options."""
    return _window(opts).astype(np.float32), mel_filterbank(opts)


def _as_wave(wave, device) -> torch.Tensor:
    """`wave` as a float32 tensor: a tensor on its own device (or `device`,
    where given), anything else on `device` (default the card)."""
    if isinstance(wave, torch.Tensor):
        t = wave if device is None else wave.to(device)
    else:
        t = torch.as_tensor(np.asarray(wave), device=device or "cuda")
    return t.to(torch.float32)


def _frames(wave: torch.Tensor, opts: FbankOptions) -> torch.Tensor:
    """wave [..., N] -> frames [..., T, frame_length]."""
    T = num_frames(wave.shape[-1], opts)
    if T == 0:
        return wave.new_zeros(wave.shape[:-1] + (0, opts.frame_length))
    return wave[..., : (T - 1) * opts.frame_shift + opts.frame_length].unfold(
        -1, opts.frame_length, opts.frame_shift
    )


def fbank(
    wave,  # [..., num_samples], float in [-1, 1] or int16 scale
    opts: FbankOptions = FbankOptions(),
    device=None,
) -> torch.Tensor:
    """Log-mel filterbank features [..., T, num_mel_bins] on the wave's
    device (see the module's docstring for `device`)."""
    x = _frames(_as_wave(wave, device), opts)
    if x.shape[-2] == 0:  # shorter than one frame (an FFT of no rows may fail)
        return x.new_zeros(x.shape[:-1] + (opts.num_mel_bins,))
    window, bank = _host_tables(opts)
    # per-frame DC offset removal, then preemphasis (Kaldi order)
    x = x - x.mean(dim=-1, keepdim=True)
    if opts.preemphasis > 0:
        prev = torch.cat([x[..., :1], x[..., :-1]], dim=-1)
        x = x - opts.preemphasis * prev
    x = x * torch.as_tensor(window, device=x.device)
    spec = torch.fft.rfft(x, n=opts.fft_size, dim=-1)
    power = torch.square(torch.abs(spec))
    mel = torch.matmul(power, torch.as_tensor(bank, device=x.device))
    return torch.log(torch.clamp(mel, min=1e-10))


def fbank64(wave, opts: FbankOptions = FbankOptions()) -> np.ndarray:
    """`fbank`'s formula (Kaldi's order) in float64 NumPy on the host: the
    yardstick that the card's and the CPU's float32 filterbanks are held
    to, within `fbank_tolerance`."""
    x = np.asarray(wave, np.float64)
    n = num_frames(x.shape[-1], opts)
    x = x[..., np.arange(n)[:, None] * opts.frame_shift + np.arange(opts.frame_length)]
    x = x - x.mean(-1, keepdims=True)
    if opts.preemphasis > 0:
        x = x - opts.preemphasis * np.concatenate([x[..., :1], x[..., :-1]], -1)
    power = np.abs(np.fft.rfft(x * _window(opts), n=opts.fft_size, axis=-1)) ** 2
    return np.log(np.maximum(power @ mel_filterbank(opts).astype(np.float64), 1e-10))


def fbank_tolerance(ref: np.ndarray) -> np.ndarray:
    """The elementwise gate of a float32 filterbank against the float64
    yardstick `ref` [..., T, M]: eps32 * (16 |ref| + 4 exp(depth / 2)).
    float32 rounds the value itself (|ref| * eps32) and the spectrum's
    amplitude, which it holds to eps32 of the frame's loudest bin, so a mel
    bin `depth` nats below its frame's loudest moves by ~eps32 * exp(depth
    / 2) in log power."""
    depth = ref.max(axis=-1, keepdims=True) - ref
    return np.finfo(np.float32).eps * (16 * np.abs(ref) + 4 * np.exp(depth / 2))


def mfcc(wave, opts: FbankOptions = FbankOptions(), device=None) -> torch.Tensor:
    """MFCC features [..., T, num_ceps]."""
    feats = fbank(wave, opts, device)
    return torch.matmul(feats, torch.as_tensor(dct_matrix(opts), device=feats.device))


def append_ivectors(feats: torch.Tensor, ivectors: torch.Tensor) -> torch.Tensor:
    """Append per-utterance auxiliary vectors (i-vectors / speaker
    embeddings) to every frame: feats [..., T, F] + ivectors [..., D] ->
    [..., T, F+D].  Kaldi chain egs carried ivectors as a separate NnetIo
    input consumed this way."""
    tiled = ivectors[..., None, :].expand(feats.shape[:-1] + (ivectors.shape[-1],))
    return torch.cat([feats, tiled], dim=-1)


def cmvn(feats: torch.Tensor, norm_var: bool = True) -> torch.Tensor:
    """Per-utterance cepstral mean (and variance) normalization over the
    time axis (axis -2), Kaldi apply-cmvn semantics."""
    mean = feats.mean(dim=-2, keepdim=True)
    out = feats - mean
    if norm_var:
        # the population variance (jnp.var's default)
        std = torch.sqrt(feats.var(dim=-2, keepdim=True, correction=0) + 1e-8)
        out = out / std
    return out


def compute_cmvn_stats(utterance_feats) -> tuple[np.ndarray, np.ndarray]:
    """Corpus-level CMVN statistics (Kaldi compute-cmvn-stats role):
    returns (mean [D], std [D]) accumulated over an iterable of [T, D]
    feature matrices (tensors or arrays), in float64 on the host."""
    n = 0
    s = None
    ss = None
    for f in utterance_feats:
        if isinstance(f, torch.Tensor):
            f = f.detach().cpu().numpy()
        f = np.asarray(f, dtype=np.float64)
        if s is None:
            s = f.sum(axis=0)
            ss = (f * f).sum(axis=0)
        else:
            s += f.sum(axis=0)
            ss += (f * f).sum(axis=0)
        n += f.shape[0]
    if n == 0:
        raise ValueError("no frames")
    mean = s / n
    var = np.maximum(ss / n - mean * mean, 1e-8)
    return mean.astype(np.float32), np.sqrt(var).astype(np.float32)


def apply_cmvn_stats(
    feats: torch.Tensor, mean: np.ndarray, std: np.ndarray, norm_var: bool = True
) -> torch.Tensor:
    """Apply precomputed corpus/speaker CMVN stats (apply-cmvn with
    external stats)."""
    out = feats - torch.as_tensor(mean, device=feats.device)
    if norm_var:
        out = out / torch.as_tensor(std, device=feats.device)
    return out
