"""Synthetic RAW-AUDIO Kaldi data dir: the dress-rehearsal fixture (a host
NumPy copy of torchain_tpu/data/synth_wav.py: the same seed writes the
same files, byte for byte).

Renders a word-level corpus as actual PCM waveforms and writes a
standard Kaldi data directory (wav.scp + segments + utt2spk + text +
lexicon.txt + phones.txt/words.txt + ali.txt), so the full recipe ladder
— wav.scp -> fbank -> per-speaker CMVN -> (speed perturb) -> iVectors ->
tied tree -> chain training -> HCLG decode -> LMWT sweep / MBR — runs
end-to-end with zero Kaldi binaries.  On a real-corpus day the data dir
is swapped; nothing else changes.

Each phone renders as a two-partial tone at a phone-specific frequency
(distinct log-mel signatures => learnable), and each SPEAKER applies a
global gain, putting a constant per-speaker offset on the log-fbank
features that per-speaker CMVN demonstrably removes.
"""

from __future__ import annotations

import pathlib

import numpy as np

from torchain_tpu_torch.data.features import FbankOptions
from torchain_tpu_torch.data.words import random_lexicon


def render_phone_wave(
    phone: int,
    num_samples: int,
    sample_rate: int,
    rng: np.random.Generator,
    noise: float = 60.0,
    amp: float = 4000.0,
) -> np.ndarray:
    """One phone as a two-partial tone + noise at int16 scale."""
    f0 = 220.0 + 170.0 * phone
    t = np.arange(num_samples) / sample_rate
    phase = rng.uniform(0, 2 * np.pi)
    x = amp * np.sin(2 * np.pi * f0 * t + phase)
    x += 0.4 * amp * np.sin(2 * np.pi * 1.5 * f0 * t + phase * 0.7)
    x += rng.normal(scale=noise, size=num_samples)
    return x.astype(np.float32)


def make_wav_data_dir(
    data_dir: str,
    num_utts: int = 24,
    vocab_size: int = 12,
    num_phones: int = 6,
    num_speakers: int = 4,
    words_per_utt: tuple[int, int] = (2, 5),
    utts_per_recording: int = 2,
    frame_subsampling_factor: int = 3,
    opts: FbankOptions | None = None,
    seed: int = 0,
) -> None:
    """Write a complete synthetic raw-audio Kaldi data dir.

    Phone durations are drawn in OUTPUT frames (x fsf at input rate) and
    waveforms rendered to exactly frame_length + (T_in - 1) * frame_shift
    samples so feature frame counts match `ali.txt` exactly.  Utterances
    are grouped `utts_per_recording` per wav file with a `segments` file
    (wav.scp keys are recordings), and speakers cycle round-robin with a
    per-speaker gain in [0.4, 2.5]."""
    if opts is None:
        opts = FbankOptions(sample_rate=8000, num_mel_bins=16)
    root = pathlib.Path(data_dir)
    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    lexicon = random_lexicon(vocab_size, num_phones, rng, max_pron_len=3)
    gains = np.exp(rng.uniform(np.log(0.4), np.log(2.5), size=num_speakers))

    fsf = frame_subsampling_factor
    flen, fshift = opts.frame_length, opts.frame_shift
    transcripts: dict[str, list[int]] = {}
    alis: dict[str, list[tuple[int, int]]] = {}
    utt2spk: dict[str, str] = {}
    waves: dict[str, np.ndarray] = {}
    for ui in range(num_utts):
        utt = f"utt{ui:03d}"
        spk_i = ui % num_speakers
        utt2spk[utt] = f"spk{spk_i}"
        words = [
            int(w)
            for w in rng.integers(1, vocab_size + 1, size=int(rng.integers(*words_per_utt)))
        ]
        transcripts[utt] = words
        ali: list[tuple[int, int]] = []
        for w in words:
            for q in lexicon.prons[w][0]:
                d_out = int(rng.integers(2, 6))
                ali.append((q, d_out * fsf))
        alis[utt] = ali
        t_in = sum(d for _, d in ali)
        chunks = []
        for q, d in ali:
            # phone spans tile the frame GRID; the tail extends the last
            # phone so total samples give exactly t_in frames
            chunks.append(render_phone_wave(q, d * fshift, opts.sample_rate, rng))
        x = np.concatenate(chunks)
        tail = flen - fshift  # frame-length tail (x[-0:] would be ALL of x)
        if tail:
            x = np.concatenate([x, x[-tail:]])
        if 1 + (x.shape[0] - flen) // fshift != t_in:
            raise RuntimeError(
                f"synth wav frame count mismatch for {utt}: "
                f"{1 + (x.shape[0] - flen) // fshift} != {t_in}"
            )
        waves[utt] = np.clip(x * gains[spk_i], -32767, 32767)

    from torchain_tpu_torch.data.kaldi_compat import write_utt2spk, write_wav

    utt_ids = sorted(waves)
    with open(root / "wav.scp", "w") as scp, open(root / "segments", "w") as seg:
        for ri in range(0, len(utt_ids), utts_per_recording):
            group = utt_ids[ri : ri + utts_per_recording]
            rec = f"rec{ri // utts_per_recording:03d}"
            samples = np.concatenate([waves[u] for u in group])
            path = root / f"{rec}.wav"
            write_wav(str(path), samples, opts.sample_rate)
            scp.write(f"{rec} {path}\n")
            pos = 0
            for u in group:
                n = waves[u].shape[0]
                seg.write(
                    f"{u} {rec} {pos / opts.sample_rate:.7g}"
                    f" {(pos + n) / opts.sample_rate:.7g}\n"
                )
                pos += n
    write_utt2spk(str(root / "utt2spk"), utt2spk)
    with open(root / "ali.txt", "w") as f:
        for utt in utt_ids:
            f.write(utt + " " + " ".join(f"{p}:{d}" for p, d in alis[utt]) + "\n")
    words_tab = {"<eps>": 0, **{f"w{w}": w for w in range(1, vocab_size + 1)}}
    phones_tab = {"<eps>": 0, **{f"p{q}": q for q in range(1, num_phones + 1)}}
    from torchain_tpu_torch.data.kaldi_compat import write_symbol_table

    write_symbol_table(str(root / "words.txt"), words_tab)
    write_symbol_table(str(root / "phones.txt"), phones_tab)
    with open(root / "text", "w") as f:
        for utt in utt_ids:
            f.write(utt + " " + " ".join(f"w{w}" for w in transcripts[utt]) + "\n")
    with open(root / "lexicon.txt", "w") as f:
        for w in sorted(lexicon.prons):
            for pron in lexicon.prons[w]:
                f.write(f"w{w} " + " ".join(f"p{q}" for q in pron) + "\n")
    with open(root / "frontend.json", "w") as f:
        import dataclasses
        import json

        json.dump(
            {
                "fbank": dataclasses.asdict(opts),
                "frame_subsampling_factor": fsf,
                "num_phones": num_phones,
            },
            f,
        )
