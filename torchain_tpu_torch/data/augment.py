"""Waveform-level data augmentation: resampling and 3-way speed perturb
(a host NumPy copy of torchain_tpu/data/augment.py, bit for bit).

The standard Kaldi chain recipe triples the corpus with 0.9x/1.0x/1.1x
speed copies before feature extraction (utils/data/
perturb_data_dir_speed_3way.sh, which shells out to `sox speed f` —
resampling that shifts both tempo and pitch).  Here the resampler is a
windowed-sinc (Kaldi's LinearResample / ArbitraryResample family,
kaldi/src/feat/resample.{h,cc}) implemented as a banked FIR over numpy —
the wav front is host-side prep.

Speed factor semantics match sox: `speed 1.1` plays the signal 1.1x
faster, so the output is SHORTER (duration / 1.1) and pitch rises 10%.
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np


def resample_waveform(
    x: np.ndarray, speed: float, num_zeros: int = 16, cutoff_scale: float = 0.95
) -> np.ndarray:
    """Play `x` back at `speed`x via windowed-sinc interpolation:
    out[n] = x(n * speed) band-limited below the narrower Nyquist.

    `speed` is snapped to a small rational p/q (sox-style factors like
    0.9, 1.0, 1.1 are exact) so the filter bank has q phases computed
    once.  Hann-windowed sinc with `num_zeros` zero-crossings per side;
    `cutoff_scale` backs the low-pass off the Nyquist edge (anti-aliasing
    margin when speeding up, transition band when slowing down)."""
    x = np.asarray(x, dtype=np.float32)
    if x.ndim != 1:
        raise ValueError("expected a mono [num_samples] waveform")
    frac = Fraction(speed).limit_denominator(1000)
    p, q = frac.numerator, frac.denominator
    if p <= 0:
        raise ValueError(f"speed must be positive, got {speed}")
    if p == q:
        return x.copy()
    n_out = (x.shape[0] * q) // p
    if n_out == 0:
        return np.zeros(0, np.float32)
    # low-pass at the narrower of the two Nyquists (in input-sample units)
    c = cutoff_scale * min(1.0, 1.0 / float(speed))
    half = int(np.ceil(num_zeros / c))
    # output n samples input position t_n = n * p / q, whose fractional
    # part is ((n*p) % q) / q — index the bank by ph = (n*p) % q directly,
    # so phase ph interpolates at fraction ph / q (a bank built on
    # (ph*p % q)/q would apply p twice: right only where p = 1 mod q; the
    # exact-reconstruction tone test pins this at speeds 0.9 and 1.1)
    taps = np.arange(-half, half + 1, dtype=np.float64)
    bank = np.empty((q, 2 * half + 1), np.float64)
    for ph in range(q):
        frac_pos = ph / q  # fractional part of t_n for this phase
        t = taps - frac_pos
        h = c * np.sinc(c * t)
        w = 0.5 * (1.0 + np.cos(np.pi * t / (half + 1)))
        w[np.abs(t) > half + 1] = 0.0
        bank[ph] = h * w
    pad = np.zeros(half, np.float32)
    xp = np.concatenate([pad, x, pad, np.zeros(p, np.float32)])
    n = np.arange(n_out)
    base = (n * p) // q  # integer part of t_n
    idx = base[:, None] + np.arange(2 * half + 1)[None, :]
    phases = (n * p) % q
    out = np.einsum(
        "nk,nk->n", xp[idx].astype(np.float64), bank[phases]
    )
    return out.astype(np.float32)


def perturb_alignment(
    alignment: list[tuple[int, int]], speed: float, num_frames: int
) -> list[tuple[int, int]]:
    """Scale (phone, duration) spans to the perturbed copy's `num_frames`
    (durations shrink when speed > 1).  Cumulative-boundary rounding keeps
    the total exactly `num_frames` and every span >= 1 frame — the
    in-process equivalent of re-aligning the perturbed audio, exact for
    the synthetic front where phone boundaries scale linearly."""
    total = sum(d for _, d in alignment)
    if total <= 0:
        raise ValueError("empty alignment")
    bounds = np.cumsum([d for _, d in alignment]) / total
    edges = np.round(bounds * num_frames).astype(int)
    out: list[tuple[int, int]] = []
    prev = 0
    for (phone, _), edge in zip(alignment, edges):
        d = int(edge) - prev
        if d <= 0:
            # a span rounded to nothing: steal one frame so the phone
            # sequence (hence transcript/LM counts) is preserved
            d = 1
        out.append((phone, d))
        prev += d
    # re-fit the tail to land exactly on num_frames
    overshoot = prev - num_frames
    i = len(out) - 1
    while overshoot > 0 and i >= 0:
        phone, d = out[i]
        take = min(d - 1, overshoot)
        out[i] = (phone, d - take)
        overshoot -= take
        i -= 1
    if overshoot > 0:
        raise ValueError(
            f"cannot fit {len(alignment)} phones into {num_frames} frames"
        )
    if prev < num_frames:
        phone, d = out[-1]
        out[-1] = (phone, d + num_frames - prev)
    return out


SP_FACTORS_3WAY = (0.9, 1.0, 1.1)


def sp_key(utt: str, factor: float) -> str:
    """perturb_data_dir_speed_3way.sh naming: factor 1.0 keeps the bare
    id, others prefix `sp<f>-`.  The single source of truth for the
    naming (speed_perturb_wavs and speed_perturb_key_map must agree or
    load_wav_dir silently drops perturbed copies)."""
    return utt if factor == 1.0 else f"sp{factor:g}-{utt}"


def speed_perturb_wavs(
    wavs: dict[str, np.ndarray],
    factors: tuple[float, ...] = SP_FACTORS_3WAY,
    num_zeros: int = 16,
) -> dict[str, np.ndarray]:
    """3-way corpus tripling at the wav front: returns
    {'sp0.9-utt': ..., 'utt': ..., 'sp1.1-utt': ...} with Kaldi's
    perturb_data_dir_speed_3way.sh naming (factor 1.0 keeps the bare id)."""
    out: dict[str, np.ndarray] = {}
    for f in factors:
        for utt, x in wavs.items():
            out[sp_key(utt, f)] = (
                x if f == 1.0 else resample_waveform(x, f, num_zeros)
            )
    return out


def speed_perturb_key_map(
    utt_ids, factors: tuple[float, ...] = SP_FACTORS_3WAY
) -> dict[str, tuple[str, float]]:
    """perturbed_id -> (source_id, factor) for re-deriving per-copy
    metadata (alignments, transcripts, speaker maps)."""
    out: dict[str, tuple[str, float]] = {}
    for f in factors:
        for utt in utt_ids:
            out[sp_key(utt, f)] = (utt, f)
    return out
