"""Kaldi-format corpus adapter: build Utterances from standard data dirs (a
port of torchain_tpu/data/kaldi_compat.py).

The reference consumed Kaldi egs archives; real deployments of this
framework instead read the PORTABLE pieces of a Kaldi data directory and
do the egs work in-process (data/loader.py):

  * features:     text ark (`feats.ark` written with ark,t: — see
                  torchain_tpu_torch.io.read_ark_text), BINARY ark (FM/DM/
                  FV/DV/CM records — io.read_ark_binary) or .npy/.npz
  * alignments:   Kaldi `ali-to-phones --write-lengths=true` text output:
                  `utt_id phone1 ,dur1 ; phone2 ,dur2 ; ...`
                  (also accepts the simpler `utt phone:dur phone:dur ...`)
  * transcripts:  `text`-style `utt_id phone1 phone2 ...` (integer phones)
                  for the e2e/flat-start path
  * phone table:  `phones.txt` symbol table (symbol -> int)
  * speakers:     `utt2spk`, `segments`, and per-speaker CMVN stats
                  (`cmvn.scp` / `cmvn.ark`, or accumulated from the features)
  * raw audio:    PCM wav files and `wav.scp` (the stdlib `wave` module)

No Kaldi binaries or compiled IO are required; everything is line-based
text that Kaldi tools can import/export losslessly.

Features from raw audio (`compute_feats_from_wav_scp`, `load_wav_dir`)
are computed by data/features.py on a torch device: the card unless the
caller passes `device`; everything else here is host NumPy.
"""

from __future__ import annotations

import pathlib

import numpy as np

from torchain_tpu_torch.data.loader import Utterance
from torchain_tpu_torch.io import read_ark


def read_phone_table(path: str) -> dict[str, int]:
    """phones.txt / words.txt: `symbol id` per line (OpenFst SymbolTable
    text format, as every Kaldi data/lang dir ships)."""
    table: dict[str, int] = {}
    for line in open(path):
        parts = line.split()
        if len(parts) >= 2:
            table[parts[0]] = int(parts[1])
    return table


#: words.txt has the identical format
read_symbol_table = read_phone_table


def write_symbol_table(path: str, table: dict[str, int]) -> None:
    """Write an OpenFst-format symbol table (id-sorted)."""
    with open(path, "w") as f:
        for sym, idx in sorted(table.items(), key=lambda kv: kv[1]):
            f.write(f"{sym} {idx}\n")


def read_text_transcripts(
    path: str, symtab: dict[str, int], strict: bool = True
) -> dict[str, list[int]]:
    """Kaldi `text` file with SYMBOLIC tokens (words or phones), mapped
    through a symbol table.  Unknown tokens raise (strict) or map to
    <unk>/<UNK> when the table defines one."""
    unk = symtab.get("<unk>", symtab.get("<UNK>"))
    out: dict[str, list[int]] = {}
    for line in open(path):
        parts = line.split()
        if len(parts) < 2:
            continue
        ids = []
        for tok in parts[1:]:
            if tok in symtab:
                ids.append(symtab[tok])
            elif unk is not None and not strict:
                ids.append(unk)
            else:
                raise ValueError(
                    f"token {tok!r} (utt {parts[0]}) not in symbol table"
                    + ("" if unk is None else "; pass strict=False for <unk>")
                )
        out[parts[0]] = ids
    return out


def parse_write_lengths_line(line: str) -> tuple[str, list[tuple[int, int]]]:
    """One line of `ali-to-phones --write-lengths=true` output:
    `utt 5 ,12 ; 28 ,5 ; 1 ,31`"""
    head, _, rest = line.strip().partition(" ")
    ali: list[tuple[int, int]] = []
    for seg in rest.split(";"):
        seg = seg.strip()
        if not seg:
            continue
        phone_s, _, dur_s = seg.partition(",")
        ali.append((int(phone_s.strip()), int(dur_s.strip())))
    return head, ali


def parse_colon_line(line: str) -> tuple[str, list[tuple[int, int]]]:
    """`utt phone:dur phone:dur ...`"""
    parts = line.split()
    ali = []
    for tok in parts[1:]:
        p, _, d = tok.partition(":")
        ali.append((int(p), int(d)))
    return parts[0], ali


def read_alignments(path: str) -> dict[str, list[tuple[int, int]]]:
    """Auto-detects the two text alignment formats above."""
    out: dict[str, list[tuple[int, int]]] = {}
    for line in open(path):
        line = line.strip()
        if not line:
            continue
        try:
            if "," in line:
                utt, ali = parse_write_lengths_line(line)
            else:
                utt, ali = parse_colon_line(line)
        except ValueError as e:
            raise ValueError(f"bad alignment line {line!r}: {e}") from e
        if not ali or any(p < 1 or d < 1 for p, d in ali):
            raise ValueError(f"invalid alignment for {utt}: {ali}")
        out[utt] = ali
    return out


def read_transcripts(path: str) -> dict[str, list[int]]:
    """`text` file with integer phone ids."""
    out: dict[str, list[int]] = {}
    for line in open(path):
        parts = line.split()
        if len(parts) >= 2:
            out[parts[0]] = [int(p) for p in parts[1:]]
    return out


def load_kaldi_dir(
    data_dir: str,
    feats_file: str = "feats.ark",
    ali_file: str = "ali.txt",
    strict: bool = False,
    cmvn: str | None = None,
    norm_var: bool = False,
) -> list[Utterance]:
    """Assemble Utterances from a directory holding `feats.ark` (text) and
    `ali.txt`.  Utterances missing either side are skipped (or raise when
    strict=True).  Feature length is cross-checked against the alignment.

    `cmvn="speaker"` normalizes each utterance with its speaker's stats
    (apply-cmvn --utt2spk role): stats come from the dir's `cmvn.scp` /
    `cmvn.ark` (compute-cmvn-stats [2, D+1] double matrices) when present,
    else are accumulated from the features via the dir's `utt2spk`.
    `cmvn="utterance"` normalizes each utterance by itself."""
    root = pathlib.Path(data_dir)
    if feats_file.endswith(".scp"):
        from torchain_tpu_torch.io import read_scp

        feats = read_scp(str(root / feats_file))
    else:
        feats = read_ark(str(root / feats_file))
    if cmvn == "utterance":
        feats = {
            u: apply_cmvn_stats_matrix(f, cmvn_stats_from_feats([f]), norm_var)
            for u, f in feats.items()
        }
    elif cmvn == "speaker":
        utt2spk = read_utt2spk(str(root / "utt2spk"))
        stats: dict[str, np.ndarray]
        if (root / "cmvn.scp").exists():
            from torchain_tpu_torch.io import read_scp

            stats = read_scp(str(root / "cmvn.scp"))
        elif (root / "cmvn.ark").exists():
            stats = read_ark(str(root / "cmvn.ark"))
        else:
            stats = compute_cmvn_stats_per_spk(feats, utt2spk)
        feats = apply_cmvn_by_speaker(feats, utt2spk, stats, norm_var)
    elif cmvn is not None:
        raise ValueError(
            f"unsupported cmvn mode {cmvn!r}: expected 'speaker', 'utterance', or None"
        )
    alis = read_alignments(str(root / ali_file))
    utts: list[Utterance] = []
    skipped = []
    for utt_id in sorted(feats):
        if utt_id not in alis:
            skipped.append(utt_id)
            continue
        f = feats[utt_id]
        ali = alis[utt_id]
        ali_len = sum(d for _, d in ali)
        if abs(ali_len - f.shape[0]) > 2:  # Kaldi-style off-by-a-couple slack
            skipped.append(utt_id)
            continue
        if ali_len != f.shape[0]:  # clip to the shorter
            t = min(ali_len, f.shape[0])
            f = f[:t]
            clipped, left = [], t
            for p, d in ali:
                d = min(d, left)
                if d <= 0:
                    break
                clipped.append((p, d))
                left -= d
            ali = clipped
        utts.append(Utterance(feats=f.astype(np.float32), alignment=ali, utt_id=utt_id))
    if skipped and strict:
        raise ValueError(f"missing/mismatched utterances: {skipped[:10]}...")
    return utts


# ---------------------------------------------------------------------------
# raw audio: wav files and wav.scp (the front of a Kaldi data dir)
# ---------------------------------------------------------------------------
#
# A real Kaldi data dir starts from `wav.scp`; features are DERIVED
# (compute-fbank-feats / compute-mfcc-feats, [K] src/featbin/).  The PCM
# reader and writer are here; the feature computation waits for the port's
# counterpart of the JAX package's data/features.py.


def read_wav(path: str, channel: int = 0) -> tuple[np.ndarray, int]:
    """Read a PCM wav file with the stdlib `wave` module.

    Returns (samples float32 at int16 scale: values in [-32768, 32767]
    regardless of source bit depth — this repo's normalization choice
    (Kaldi's wave reader keeps raw integer magnitudes for non-16-bit PCM,
    so exact-value feature parity with Kaldi holds for 16-bit sources;
    other depths differ by a constant log offset that CMVN removes) —
    and sample_rate.  Supports 8/16/24/32-bit PCM; multi-channel files
    yield the requested channel (compute-*-feats --channel semantics)."""
    import wave

    with wave.open(path, "rb") as w:
        nch, width, rate, nframes = (
            w.getnchannels(),
            w.getsampwidth(),
            w.getframerate(),
            w.getnframes(),
        )
        raw = w.readframes(nframes)
    if width == 1:  # unsigned 8-bit -> centre, scale to int16 range
        x = np.frombuffer(raw, dtype=np.uint8).astype(np.float32)
        x = (x - 128.0) * 256.0
    elif width == 2:
        x = np.frombuffer(raw, dtype="<i2").astype(np.float32)
    elif width == 3:  # packed 24-bit little-endian
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        x = (
            b[:, 0].astype(np.int32)
            | (b[:, 1].astype(np.int32) << 8)
            | (b[:, 2].astype(np.int32) << 16)
        )
        x = np.where(x >= 1 << 23, x - (1 << 24), x).astype(np.float32) / 256.0
    elif width == 4:
        x = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 65536.0
    else:
        raise ValueError(f"unsupported PCM sample width {width} in {path}")
    if nch > 1:
        if not 0 <= channel < nch:
            raise ValueError(f"channel {channel} out of range for {nch}-channel {path}")
        x = x[channel::nch]
    return np.ascontiguousarray(x), rate


def write_wav(path: str, samples: np.ndarray, sample_rate: int) -> None:
    """Write mono 16-bit PCM (samples at int16 scale, clipped)."""
    import wave

    x = np.clip(np.asarray(samples, np.float32), -32768.0, 32767.0)
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(int(sample_rate))
        w.writeframes(np.rint(x).astype("<i2").tobytes())


def read_wav_scp(path: str, skip_pipes: bool = False) -> dict[str, str]:
    """Parse `wav.scp` lines `utt_id /path/to/file.wav`.

    Command-pipe entries (`utt sox ... |`) need a shell and external
    tools; by default they are rejected with a clear error rather than
    silently mis-read — pre-extract such sources to plain wav files
    first.  Real corpora often mix plain-wav and piped entries
    (sph2pipe/sox lines); pass skip_pipes=True to consume the plain-wav
    subset and drop the piped entries instead of failing the whole file."""
    out: dict[str, str] = {}
    with open(path) as f:
        for line in f:
            parts = line.strip().split(None, 1)
            if not parts:
                continue
            if len(parts) != 2:
                raise ValueError(f"malformed wav.scp line: {line!r}")
            utt, target = parts
            if target.endswith("|"):
                if skip_pipes:
                    continue
                raise ValueError(
                    f"wav.scp entry for {utt!r} is a command pipe ({target!r});"
                    " pre-extract it to a plain wav file, or pass"
                    " skip_pipes=True to consume only the plain-wav entries"
                )
            out[utt] = target
    return out



def compute_feats_from_wav_scp(
    scp_path: str,
    opts=None,
    feat_type: str = "fbank",
    channel: int = 0,
    segments_path: str | None = None,
    device=None,
) -> dict[str, np.ndarray]:
    """compute-fbank-feats / compute-mfcc-feats role: wav.scp -> per-utt
    feature matrices using the in-repo feature frontend (data/features.py,
    Povey window + mel bank + optional DCT) on `device` (default the
    card), returned as float32 NumPy.  Sample rates must match
    `opts.sample_rate` (Kaldi errors here too rather than resampling).

    With `segments_path`, wav.scp keys are RECORDING ids and each
    `segments` row yields one utterance from its recording's
    [start_s, end_s) sample slice (extract-segments role); each recording
    is read once."""
    from torchain_tpu_torch.data.features import FbankOptions, fbank, mfcc

    if opts is None:
        opts = FbankOptions()
    if feat_type not in ("fbank", "mfcc"):
        raise ValueError(
            f"unsupported feat_type {feat_type!r}: expected 'fbank' or 'mfcc'"
        )
    fn = {"fbank": fbank, "mfcc": mfcc}[feat_type]
    waves = extract_utterance_waves(
        scp_path,
        segments_path=segments_path,
        channel=channel,
        expected_rate=opts.sample_rate,
    )
    return {
        utt: fn(x, opts, device=device).cpu().numpy().astype(np.float32)
        for utt, x in waves.items()
    }

def extract_utterance_waves(
    scp_path: str,
    segments_path: str | None = None,
    channel: int = 0,
    expected_rate: int | None = None,
) -> dict[str, np.ndarray]:
    """Per-UTTERANCE sample arrays from wav.scp (+ optional `segments`
    slicing — extract-segments role; each recording is read once).  The
    waveform front for feature computation and wav-level augmentation."""
    wavs = read_wav_scp(scp_path)

    def _load(path: str) -> np.ndarray:
        samples, rate = read_wav(path, channel=channel)
        if expected_rate is not None and rate != expected_rate:
            raise ValueError(
                f"{path}: wav sample rate {rate} != expected {expected_rate}"
            )
        return samples

    if segments_path is None:
        return {utt: _load(path) for utt, path in wavs.items()}
    if expected_rate is None:
        raise ValueError("segments slicing requires expected_rate")
    segs = read_segments(segments_path)
    by_rec: dict[str, list[str]] = {}
    for utt, (rec, _, _) in segs.items():
        by_rec.setdefault(rec, []).append(utt)
    missing = sorted(set(by_rec) - set(wavs))
    if missing:
        raise ValueError(f"segments reference recordings not in wav.scp: {missing[:10]}")
    out: dict[str, np.ndarray] = {}
    for rec, utts in by_rec.items():
        samples = _load(wavs[rec])
        for utt in utts:
            _, start, end = segs[utt]
            a, b = int(round(start * expected_rate)), int(round(end * expected_rate))
            if a >= samples.shape[0]:
                raise ValueError(
                    f"segment {utt} starts at {start}s, beyond recording {rec}"
                )
            if b > samples.shape[0]:
                raise ValueError(
                    f"segment {utt} ends at {end}s, beyond recording {rec}"
                    f" ({samples.shape[0] / expected_rate:.2f}s)"
                )
            out[utt] = samples[a:b]
    return out


# ---------------------------------------------------------------------------
# speaker structure: utt2spk / spk2utt / segments / per-speaker CMVN
# ---------------------------------------------------------------------------
#
# A real Kaldi data dir normalizes features PER SPEAKER: utt2spk groups
# utterances, compute-cmvn-stats accumulates one [2, D+1] double-matrix
# per speaker (row 0 = [sum_x..., frame_count], row 1 = [sum_x^2..., 0],
# kaldi/src/transform/cmvn.cc), cmvn.scp indexes them, and apply-cmvn
# subtracts each speaker's mean (variance optionally).  `segments` maps
# utterances to (recording, start_s, end_s) time slices of wav.scp rows.


def read_utt2spk(path: str) -> dict[str, str]:
    """`utt2spk`: one `utt_id spk_id` per line."""
    out: dict[str, str] = {}
    for line in open(path):
        parts = line.split()
        if len(parts) == 2:
            out[parts[0]] = parts[1]
        elif parts:
            raise ValueError(f"malformed utt2spk line: {line!r}")
    return out


def write_utt2spk(path: str, utt2spk: dict[str, str]) -> None:
    with open(path, "w") as f:
        for utt in sorted(utt2spk):
            f.write(f"{utt} {utt2spk[utt]}\n")


def spk2utt_from_utt2spk(utt2spk: dict[str, str]) -> dict[str, list[str]]:
    """Invert utt2spk (utils/utt2spk_to_spk2utt.pl role); utterance lists
    are sorted as Kaldi keeps them."""
    out: dict[str, list[str]] = {}
    for utt in sorted(utt2spk):
        out.setdefault(utt2spk[utt], []).append(utt)
    return out


def read_segments(path: str) -> dict[str, tuple[str, float, float]]:
    """`segments`: `utt_id recording_id start_s end_s` per line (the file
    that makes wav.scp keys RECORDINGS rather than utterances)."""
    out: dict[str, tuple[str, float, float]] = {}
    for line in open(path):
        parts = line.split()
        if not parts:
            continue
        if len(parts) != 4:
            raise ValueError(f"malformed segments line: {line!r}")
        utt, rec, start, end = parts
        s, e = float(start), float(end)
        if not (0.0 <= s < e):
            raise ValueError(f"bad segment times for {utt}: {s}..{e}")
        out[utt] = (rec, s, e)
    return out


def cmvn_stats_from_feats(utterance_feats) -> np.ndarray:
    """Accumulate Kaldi CMVN stats over an iterable of [T, D] matrices:
    a [2, D+1] float64 matrix (compute-cmvn-stats output layout)."""
    stats = None
    for f in utterance_feats:
        f = np.asarray(f, dtype=np.float64)
        if stats is None:
            stats = np.zeros((2, f.shape[1] + 1), dtype=np.float64)
        stats[0, :-1] += f.sum(axis=0)
        stats[0, -1] += f.shape[0]
        stats[1, :-1] += (f * f).sum(axis=0)
    if stats is None or stats[0, -1] == 0:
        raise ValueError("no frames")
    return stats


def compute_cmvn_stats_per_spk(
    feats: dict[str, np.ndarray], utt2spk: dict[str, str]
) -> dict[str, np.ndarray]:
    """compute-cmvn-stats --spk2utt role: one [2, D+1] stats matrix per
    speaker.  Utterances without a speaker mapping raise."""
    missing = sorted(set(feats) - set(utt2spk))
    if missing:
        raise ValueError(f"utterances missing from utt2spk: {missing[:10]}")
    out: dict[str, np.ndarray] = {}
    for spk, utts in spk2utt_from_utt2spk(
        {u: s for u, s in utt2spk.items() if u in feats}
    ).items():
        out[spk] = cmvn_stats_from_feats(feats[u] for u in utts)
    return out


def apply_cmvn_stats_matrix(
    feats: np.ndarray, stats: np.ndarray, norm_var: bool = False
) -> np.ndarray:
    """apply-cmvn with a Kaldi [2, D+1] stats matrix (default
    --norm-vars=false, matching the binary)."""
    stats = np.asarray(stats, dtype=np.float64)
    count = stats[0, -1]
    if count <= 0:
        raise ValueError("CMVN stats have zero frame count")
    mean = stats[0, :-1] / count
    out = np.asarray(feats, np.float32) - mean.astype(np.float32)
    if norm_var:
        var = np.maximum(stats[1, :-1] / count - mean * mean, 1e-20)
        out = out / np.sqrt(var).astype(np.float32)
    return out


def apply_cmvn_by_speaker(
    feats: dict[str, np.ndarray],
    utt2spk: dict[str, str],
    stats_by_spk: dict[str, np.ndarray],
    norm_var: bool = False,
) -> dict[str, np.ndarray]:
    """Speaker-normalized copies of `feats` (apply-cmvn --utt2spk role)."""
    out = {}
    for utt, f in feats.items():
        spk = utt2spk.get(utt)
        if spk is None:
            raise ValueError(f"utterance {utt!r} missing from utt2spk")
        if spk not in stats_by_spk:
            raise ValueError(f"speaker {spk!r} missing from CMVN stats")
        out[utt] = apply_cmvn_stats_matrix(f, stats_by_spk[spk], norm_var)
    return out



def load_wav_dir(
    data_dir: str,
    opts=None,
    cmvn: str | None = "speaker",
    norm_var: bool = False,
    speed_perturb: bool = False,
    context_width: int = 1,
    lm_order: int = 2,
    lm_extra_states: int = 200,
    frame_subsampling_factor: int | None = None,
    num_phones: int | None = None,
    device=None,
    timings: dict | None = None,
):
    """Assemble a trainable WordCorpus from a RAW-AUDIO Kaldi data dir:
    wav.scp [+ segments] -> fbank -> [3-way speed perturb] ->
    [per-speaker CMVN] -> Utterances + phone LM + den graph, with the
    word transcripts/lexicon for HCLG decoding.  The full front of a Kaldi
    chain recipe with zero Kaldi binaries.

    Expects: `wav.scp` (+`segments`), `ali.txt` (phone alignments at the
    input frame rate), and for word decoding `text` + `words.txt` +
    `lexicon.txt` + `phones.txt`.  `utt2spk` enables cmvn="speaker".
    A `frontend.json` (written by synth_wav.make_wav_data_dir) supplies
    feature options; explicit arguments override it.

    The filterbank runs on `device` (default the card); the rest on the
    host.  Where `timings` is a dict, the host seconds of each stage go
    into it: wav_read_s, speed_perturb_s, fbank_s (the device's work
    included: the features come back to the host), cmvn_s, graph_s."""
    import json as _json
    import time as _time

    from torchain_tpu_torch.data.features import FbankOptions, fbank, num_frames
    from torchain_tpu_torch.data.words import WordCorpus

    tm = timings if timings is not None else {}
    t0 = _time.perf_counter()
    root = pathlib.Path(data_dir)
    meta = {}
    if (root / "frontend.json").exists():
        meta = _json.loads((root / "frontend.json").read_text())
    if opts is None:
        opts = FbankOptions(**meta.get("fbank", {}))
    fsf = frame_subsampling_factor or meta.get("frame_subsampling_factor", 3)

    waves = extract_utterance_waves(
        str(root / "wav.scp"),
        segments_path=str(root / "segments") if (root / "segments").exists() else None,
        expected_rate=opts.sample_rate,
    )
    alis = read_alignments(str(root / "ali.txt"))
    utt2spk = (
        read_utt2spk(str(root / "utt2spk"))
        if (root / "utt2spk").exists()
        else {u: "global" for u in waves}
    )
    transcripts: dict[str, list[int]] = {}
    lexicon = None
    if (root / "text").exists() and (root / "words.txt").exists():
        words_tab = read_phone_table(str(root / "words.txt"))
        transcripts = read_text_transcripts(str(root / "text"), words_tab)
        if (root / "lexicon.txt").exists() and (root / "phones.txt").exists():
            from torchain_tpu_torch.graphs.hclg import Lexicon

            phones_tab = read_phone_table(str(root / "phones.txt"))
            prons: dict[int, list[tuple[int, ...]]] = {}
            for line in open(root / "lexicon.txt"):
                parts = line.split()
                if len(parts) < 2:
                    continue
                w = words_tab[parts[0]]
                prons.setdefault(w, []).append(
                    tuple(phones_tab[q] for q in parts[1:])
                )
            lexicon = Lexicon(prons=prons)
    if num_phones is None:
        num_phones = meta.get("num_phones") or max(
            p for ali in alis.values() for p, _ in ali
        )
    tm["wav_read_s"] = _time.perf_counter() - t0

    t0 = _time.perf_counter()
    if speed_perturb:
        from torchain_tpu_torch.data.augment import (
            perturb_alignment,
            speed_perturb_key_map,
            speed_perturb_wavs,
        )

        waves = speed_perturb_wavs(waves)
        keymap = speed_perturb_key_map(list(alis))
        new_alis, new_u2s, new_tr = {}, {}, {}
        for key, (src, f) in keymap.items():
            if key not in waves or src not in alis:
                continue
            t_in = num_frames(waves[key].shape[0], opts)
            new_alis[key] = (
                alis[src] if f == 1.0 else perturb_alignment(alis[src], f, t_in)
            )
            spk = utt2spk.get(src, "global")
            new_u2s[key] = spk if f == 1.0 else f"sp{f:g}-{spk}"
            if src in transcripts:
                new_tr[key] = transcripts[src]
        alis, utt2spk, transcripts = new_alis, new_u2s, new_tr
    tm["speed_perturb_s"] = _time.perf_counter() - t0

    t0 = _time.perf_counter()
    feats = {
        u: fbank(x, opts, device=device).cpu().numpy().astype(np.float32)
        for u, x in waves.items()
    }
    tm["fbank_s"] = _time.perf_counter() - t0
    t0 = _time.perf_counter()
    if cmvn == "speaker":
        stats = compute_cmvn_stats_per_spk(feats, utt2spk)
        feats = apply_cmvn_by_speaker(feats, utt2spk, stats, norm_var)
    elif cmvn == "utterance":
        feats = {
            u: apply_cmvn_stats_matrix(f, cmvn_stats_from_feats([f]), norm_var)
            for u, f in feats.items()
        }
    elif cmvn is not None:
        raise ValueError(f"unsupported cmvn mode {cmvn!r}")
    tm["cmvn_s"] = _time.perf_counter() - t0

    from torchain_tpu_torch.data.loader import SyntheticCorpus
    from torchain_tpu_torch.graphs import (
        ContextTree,
        PhoneLmOptions,
        compile_den_graph,
        estimate_phone_lm,
        make_den_fst,
        make_dense_den_graph,
        make_normalization_fst,
    )

    t0 = _time.perf_counter()
    utts = []
    tr_list = []
    for utt in sorted(feats):
        if utt not in alis:
            continue
        f, ali = feats[utt], alis[utt]
        t_ali = sum(d for _, d in ali)
        if abs(t_ali - f.shape[0]) > 2:
            raise ValueError(
                f"{utt}: alignment covers {t_ali} frames, features have {f.shape[0]}"
            )
        utts.append(Utterance(feats=f, alignment=ali, utt_id=utt))
        tr_list.append(transcripts.get(utt, []))
    if not utts:
        raise ValueError(f"no usable utterances in {data_dir}")
    sents = [[p for p, _ in u.alignment] for u in utts]
    tree = ContextTree(num_phones, context_width=context_width)
    lm = estimate_phone_lm(
        sents, PhoneLmOptions(ngram_order=lm_order, num_extra_lm_states=lm_extra_states)
    )
    den_fst = make_den_fst(lm, tree)
    graph = compile_den_graph(den_fst, tree.num_pdfs)
    # the dense Moore form only while its V stays small (the JAX package's
    # threshold)
    dense = make_dense_den_graph(graph) if graph.num_states <= 2500 else None
    norm = make_normalization_fst(den_fst, graph.initial_probs)
    corpus = SyntheticCorpus(
        utts=utts,
        tree=tree,
        den_graph=graph,
        dense_den=dense,
        norm_fst=norm,
        den_fst=den_fst,
        feat_dim=utts[0].feats.shape[1],
        pdf_means=np.zeros((tree.num_pdfs, utts[0].feats.shape[1]), np.float32),
        phone_lm=lm,
    )
    tm["graph_s"] = _time.perf_counter() - t0
    return WordCorpus(corpus=corpus, lexicon=lexicon, transcripts=tr_list)

# Kaldi `tree` files (ContextDependency text format) parse into TiedTree —
# the pdf-map import route for matching an existing Kaldi system's pdf
# inventory (kaldi/src/tree/; see graphs/tied_tree.py for the format).
from torchain_tpu_torch.graphs.tied_tree import read_kaldi_tree, write_kaldi_tree  # noqa: E402,F401
