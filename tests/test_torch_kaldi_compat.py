"""The port's Kaldi data-directory adapter (torchain_tpu_torch/data/
kaldi_compat.py) against the JAX package's: the alignment, transcript and
symbol-table parsers, `load_kaldi_dir` without CMVN, with speaker CMVN (stats
from cmvn.scp, from cmvn.ark, and accumulated from the features) and with
utterance CMVN, the wav reader and writer at every PCM width, wav.scp and
segments, utt2spk and the CMVN helpers.  The data dirs are the JAX tests'
(tests/test_kaldi_compat.py), their numbers drawn from a seed; every
result must be equal."""

import wave

import numpy as np
import pytest

pytest.importorskip("jax")

from torchain_tpu.data import kaldi_compat as jkc
from torchain_tpu.io import MatrixWriter, write_ark_binary
from torchain_tpu_torch.data import kaldi_compat as tkc


def _same_utts(got, want):
    assert [u.utt_id for u in got] == [u.utt_id for u in want]
    for a, b in zip(got, want):
        assert a.alignment == b.alignment
        assert a.feats.dtype == b.feats.dtype and np.array_equal(a.feats, b.feats), a.utt_id


def test_alignment_and_transcript_parsers_equal_jax(tmp_path):
    for line in ("utt1 5 ,12 ; 28 ,5 ; 1 ,31", "u 3 ,1 ;"):
        assert tkc.parse_write_lengths_line(line) == jkc.parse_write_lengths_line(line)
    assert tkc.parse_colon_line("utt2 3:4 1:2") == jkc.parse_colon_line("utt2 3:4 1:2")
    p = tmp_path / "ali.txt"
    for text in ("a 1 ,3 ; 2 ,4\nb 3 ,1\n", "a 1:3 2:4\n\nb 2:2\n"):
        p.write_text(text)
        assert tkc.read_alignments(str(p)) == jkc.read_alignments(str(p))
    for bad in ("a 0:3\n", "a 1 ,x\n"):
        p.write_text(bad)
        with pytest.raises(ValueError):
            jkc.read_alignments(str(p))
        with pytest.raises(ValueError):
            tkc.read_alignments(str(p))
    (tmp_path / "text").write_text("u1 1 2 1\nu2\nu3 4\n")
    assert tkc.read_transcripts(str(tmp_path / "text")) == jkc.read_transcripts(
        str(tmp_path / "text"))


def test_symbol_tables_and_symbolic_text_equal_jax(tmp_path):
    tab = {"<eps>": 0, "hello": 1, "world": 2, "<unk>": 3}
    tkc.write_symbol_table(str(tmp_path / "t.txt"), tab)
    jkc.write_symbol_table(str(tmp_path / "j.txt"), tab)
    assert (tmp_path / "t.txt").read_bytes() == (tmp_path / "j.txt").read_bytes()
    assert tkc.read_symbol_table(str(tmp_path / "j.txt")) == tab
    t = tmp_path / "text"
    t.write_text("u1 hello world\nu2 world mars hello\n")
    with pytest.raises(ValueError):
        tkc.read_text_transcripts(str(t), tab)
    assert tkc.read_text_transcripts(str(t), tab, strict=False) == jkc.read_text_transcripts(
        str(t), tab, strict=False)


def _data_dir(path, seed, alis, D=6, cmvn_files=True, lengths=None):
    """A data dir of the JAX tests: feats.ark (text), ali.txt, utt2spk of
    two speakers and, with `cmvn_files`, cmvn.ark + cmvn.scp of the
    speakers' stats (compute-cmvn-stats layout)."""
    rng = np.random.default_rng(seed)
    path.mkdir()
    lengths = lengths or {}
    with MatrixWriter(str(path / "feats.ark")) as w:
        for utt, ali in alis.items():
            T = lengths.get(utt, sum(d for _, d in ali))
            w[utt] = (rng.normal(size=(T, D)) * 3 + 5).astype(np.float32)
    (path / "ali.txt").write_text("".join(
        utt + " " + " ; ".join(f"{p} ,{d}" for p, d in ali) + "\n" for utt, ali in alis.items()))
    u2s = {u: f"spk{i % 2}" for i, u in enumerate(sorted(alis))}
    jkc.write_utt2spk(str(path / "utt2spk"), u2s)
    if cmvn_files:
        feats = jkc.read_ark(str(path / "feats.ark"))
        write_ark_binary(str(path / "cmvn.ark"), jkc.compute_cmvn_stats_per_spk(feats, u2s),
                         scp_path=str(path / "cmvn.scp"))
    return path


ALIS = {"u1": [(1, 10), (2, 5)], "u2": [(2, 8), (1, 8)], "u3": [(3, 4), (1, 6), (2, 3)],
        "u4": [(1, 9)]}


@pytest.mark.parametrize("cmvn,norm_var", [(None, False), ("speaker", False), ("speaker", True),
                                           ("utterance", False), ("utterance", True)])
@pytest.mark.parametrize("stats_from", ["cmvn.scp", "cmvn.ark", "feats"])
def test_load_kaldi_dir_equals_jax(tmp_path, cmvn, norm_var, stats_from):
    d = _data_dir(tmp_path / "d", 4, ALIS, cmvn_files=stats_from != "feats")
    if stats_from == "cmvn.ark":
        (d / "cmvn.scp").unlink()
    got = tkc.load_kaldi_dir(str(d), cmvn=cmvn, norm_var=norm_var)
    want = jkc.load_kaldi_dir(str(d), cmvn=cmvn, norm_var=norm_var)
    assert len(got) == len(ALIS)
    _same_utts(got, want)


def test_load_kaldi_dir_clips_skips_and_refuses_as_jax(tmp_path):
    d = _data_dir(tmp_path / "d", 1, {"u1": [(1, 10), (2, 5)], "u2": [(1, 10), (2, 5)],
                                      "u3": [(2, 4)]},
                  D=4, lengths={"u1": 14, "u2": 30})
    (d / "ali.txt").write_text((d / "ali.txt").read_text() + "u9 1 ,3\n")
    got, want = tkc.load_kaldi_dir(str(d)), jkc.load_kaldi_dir(str(d))
    assert [u.utt_id for u in got] == ["u1", "u3"]  # u2 is off by more than 2
    _same_utts(got, want)
    with pytest.raises(ValueError):
        tkc.load_kaldi_dir(str(d), strict=True)
    with pytest.raises(ValueError, match="cmvn mode"):
        tkc.load_kaldi_dir(str(d), cmvn="global")


def test_cmvn_helpers_equal_jax():
    rng = np.random.default_rng(3)
    feats = {u: rng.normal(2.0, 3.0, size=(10 + i, 5)).astype(np.float32)
             for i, u in enumerate("abcd")}
    u2s = {"a": "s1", "b": "s1", "c": "s2", "d": "s2"}
    assert tkc.spk2utt_from_utt2spk(u2s) == jkc.spk2utt_from_utt2spk(u2s)
    stats = tkc.compute_cmvn_stats_per_spk(feats, u2s)
    want = jkc.compute_cmvn_stats_per_spk(feats, u2s)
    assert set(stats) == set(want)
    for s in stats:
        assert stats[s].dtype == np.float64 and np.array_equal(stats[s], want[s])
    np.testing.assert_array_equal(tkc.cmvn_stats_from_feats(feats.values()),
                                  jkc.cmvn_stats_from_feats(feats.values()))
    for norm_var in (False, True):
        a = tkc.apply_cmvn_by_speaker(feats, u2s, stats, norm_var)
        b = jkc.apply_cmvn_by_speaker(feats, u2s, want, norm_var)
        for u in feats:
            assert a[u].dtype == b[u].dtype and np.array_equal(a[u], b[u])
    with pytest.raises(ValueError, match="missing from utt2spk"):
        tkc.apply_cmvn_by_speaker(feats, {"a": "s1"}, stats)
    with pytest.raises(ValueError, match="missing from utt2spk"):
        tkc.compute_cmvn_stats_per_spk(feats, {"a": "s1"})
    with pytest.raises(ValueError, match="zero frame count"):
        tkc.apply_cmvn_stats_matrix(feats["a"], np.zeros((2, 6)))


def test_utt2spk_and_segments_equal_jax(tmp_path):
    u2s = {"u2": "spkB", "u1": "spkA", "u3": "spkA"}
    tkc.write_utt2spk(str(tmp_path / "t"), u2s)
    jkc.write_utt2spk(str(tmp_path / "j"), u2s)
    assert (tmp_path / "t").read_bytes() == (tmp_path / "j").read_bytes()
    assert tkc.read_utt2spk(str(tmp_path / "j")) == u2s
    p = tmp_path / "segments"
    p.write_text("u1 rec1 0.0 1.5\nu2 rec1 1.5 3.0\nu3 rec2 0.25 0.75\n")
    assert tkc.read_segments(str(p)) == jkc.read_segments(str(p))
    for bad in ("u1 rec1 2.0 1.0\n", "u1 rec1 1.0\n"):
        p.write_text(bad)
        with pytest.raises(ValueError):
            tkc.read_segments(str(p))


def _write_pcm(path, width, channels, data: bytes):
    with wave.open(path, "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(width)
        w.setframerate(8000)
        w.writeframes(data)


@pytest.mark.parametrize("width,channels", [(1, 1), (2, 1), (2, 2), (3, 1), (4, 2)])
def test_read_wav_equals_jax(tmp_path, width, channels):
    rng = np.random.default_rng(width * 10 + channels)
    path = str(tmp_path / "a.wav")
    _write_pcm(path, width, channels, rng.integers(0, 256, size=120 * width * channels,
                                                   dtype=np.uint8).tobytes())
    for ch in range(channels):
        x, rate = tkc.read_wav(path, channel=ch)
        y, jrate = jkc.read_wav(path, channel=ch)
        assert rate == jrate == 8000
        assert x.dtype == y.dtype and np.array_equal(x, y)
    if channels > 1:  # a mono file ignores --channel, as the JAX reader does
        with pytest.raises(ValueError):
            tkc.read_wav(path, channel=channels)


def test_write_wav_bytes_equal_jax(tmp_path):
    x = np.concatenate([np.random.default_rng(0).normal(size=400) * 9000,
                        [0.6, -0.6, 99.5, -99.5, 4e4, -4e4]]).astype(np.float32)
    tkc.write_wav(str(tmp_path / "t.wav"), x, 16000)
    jkc.write_wav(str(tmp_path / "j.wav"), x, 16000)
    assert (tmp_path / "t.wav").read_bytes() == (tmp_path / "j.wav").read_bytes()


def test_wav_scp_and_segments_equal_jax(tmp_path):
    rng = np.random.default_rng(5)
    paths = {}
    for rec in ("rec1", "rec2"):
        paths[rec] = str(tmp_path / f"{rec}.wav")
        tkc.write_wav(paths[rec], np.round(rng.standard_normal(16000) * 1000), 8000)
    scp = tmp_path / "wav.scp"
    scp.write_text("".join(f"{r} {p}\n" for r, p in paths.items()))
    assert tkc.read_wav_scp(str(scp)) == jkc.read_wav_scp(str(scp)) == paths
    seg = tmp_path / "segments"
    seg.write_text("u1 rec1 0.0 1.0\nu2 rec1 1.0 2.0\nu3 rec2 0.25 1.75\n")
    for segments, rate in ((None, None), (None, 8000), (str(seg), 8000)):
        got = tkc.extract_utterance_waves(str(scp), segments_path=segments, expected_rate=rate)
        want = jkc.extract_utterance_waves(str(scp), segments_path=segments, expected_rate=rate)
        assert list(got) == list(want)
        for u in got:
            assert np.array_equal(got[u], want[u])
    with pytest.raises(ValueError, match="expected"):
        tkc.extract_utterance_waves(str(scp), expected_rate=16000)
    for bad, match in (("u1 recX 0.0 1.0\n", "not in wav.scp"),
                       ("u1 rec1 5.0 6.0\n", "beyond recording"),
                       ("u1 rec1 0.0 60.0\n", "ends at")):
        seg.write_text(bad)
        with pytest.raises(ValueError, match=match):
            tkc.extract_utterance_waves(str(scp), segments_path=str(seg), expected_rate=8000)
    scp.write_text(scp.read_text() + "u9 sph2pipe -f wav x.sph |\n")
    with pytest.raises(ValueError, match="command pipe"):
        tkc.read_wav_scp(str(scp))
    assert tkc.read_wav_scp(str(scp), skip_pipes=True) == paths


def test_tree_io_is_reexported():
    from torchain_tpu_torch.graphs import tied_tree

    assert tkc.read_kaldi_tree is tied_tree.read_kaldi_tree
    assert tkc.write_kaldi_tree is tied_tree.write_kaldi_tree
    assert callable(tkc.compute_feats_from_wav_scp) and callable(tkc.load_wav_dir)
