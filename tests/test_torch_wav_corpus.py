"""The raw-audio front of the port against the JAX package's:
data/synth_wav.py writes the JAX package's data dir byte for byte, and
data/kaldi_compat.py `load_wav_dir` (filterbank on a torch device, here the
CPU) assembles the same corpus as the JAX one — keys, alignments,
transcripts, lexicon, tree, den graph and normalization FST equal, the
features within the filterbank's gate — for every CMVN mode, with and
without 3-way speed perturbation; `compute_feats_from_wav_scp` likewise;
and the corpus trains a step on the CPU.

Feature tolerance: the two packages' float32 filterbanks agree within
2 * TONE_ATOL (6e-3) on these tones (tests/test_torch_features.py); speaker
or utterance CMVN subtracts means of such values, so the gate stays
2 * TONE_ATOL; with the variance normalized it also divides by a standard
deviation (at least 0.73 on this fixture), so the gate there is
2 * TONE_ATOL / 0.4 = 1.5e-2."""

import pathlib

import numpy as np
import pytest

pytest.importorskip("jax")

import torch

from tests.test_torch_features import TONE_ATOL
from torchain_tpu.data import kaldi_compat as jkc
from torchain_tpu.data.synth_wav import make_wav_data_dir as j_make
from torchain_tpu_torch.data import kaldi_compat as tkc
from torchain_tpu_torch.data.synth_wav import make_wav_data_dir as t_make

#: the fixture of tests/test_wav_corpus.py
FIXTURE = dict(num_utts=8, vocab_size=6, num_phones=4, num_speakers=2, seed=0)


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    t = tmp_path_factory.mktemp("wav_t")
    j = tmp_path_factory.mktemp("wav_j")
    t_make(str(t), **FIXTURE)
    j_make(str(j), **FIXTURE)
    return str(t), str(j)


def test_synth_wav_writes_the_jax_packages_files_byte_for_byte(dirs):
    t, j = (pathlib.Path(d) for d in dirs)
    names = sorted(p.name for p in t.iterdir())
    assert names == sorted(p.name for p in j.iterdir())
    assert sum(n.endswith(".wav") for n in names) == 4
    for n in names:
        a, b = (t / n).read_bytes(), (j / n).read_bytes()
        if n == "wav.scp":  # the paths name each directory
            a = a.replace(str(t).encode(), b"D")
            b = b.replace(str(j).encode(), b"D")
        assert a == b, n


def _same_corpus(got, want, norm_var_gate: bool):
    gc, wc = got.corpus, want.corpus
    assert [u.utt_id for u in gc.utts] == [u.utt_id for u in wc.utts]
    assert got.transcripts == want.transcripts
    assert got.lexicon.prons == want.lexicon.prons
    atol = 2 * TONE_ATOL / 0.4 if norm_var_gate else 2 * TONE_ATOL
    for a, b in zip(gc.utts, wc.utts):
        assert a.alignment == b.alignment
        assert a.feats.dtype == np.float32 and a.feats.shape == b.feats.shape
        np.testing.assert_allclose(a.feats, b.feats, rtol=0, atol=atol, err_msg=a.utt_id)
    assert gc.feat_dim == wc.feat_dim
    assert gc.tree.num_pdfs == wc.tree.num_pdfs
    for f in ("in_offsets", "in_src", "in_pdf", "in_logw", "initial_probs"):
        np.testing.assert_array_equal(getattr(gc.den_graph, f), getattr(wc.den_graph, f))
    assert (gc.dense_den is None) == (wc.dense_den is None)
    ga = [(s, a.label, a.dst, float(a.weight)) for s, a in gc.norm_fst.all_arcs()]
    wa = [(s, a.label, a.dst, float(a.weight)) for s, a in wc.norm_fst.all_arcs()]
    assert ga == wa


@pytest.mark.parametrize("speed_perturb", [False, True], ids=["plain", "sp3"])
@pytest.mark.parametrize("cmvn", ["speaker", "utterance", None])
def test_load_wav_dir_matches_the_jax_package(dirs, cmvn, speed_perturb):
    t, _ = dirs
    timings = {}
    got = tkc.load_wav_dir(t, cmvn=cmvn, speed_perturb=speed_perturb, device="cpu",
                           timings=timings)
    want = jkc.load_wav_dir(t, cmvn=cmvn, speed_perturb=speed_perturb)
    _same_corpus(got, want, norm_var_gate=False)
    assert len(got.corpus.utts) == 8 * (3 if speed_perturb else 1)
    assert set(timings) == {"wav_read_s", "speed_perturb_s", "fbank_s", "cmvn_s", "graph_s"}
    if speed_perturb:
        ids = {u.utt_id for u in got.corpus.utts}
        assert {"utt000", "sp0.9-utt000", "sp1.1-utt000"} <= ids


def test_load_wav_dir_with_variance_normalization(dirs):
    t, _ = dirs
    got = tkc.load_wav_dir(t, cmvn="speaker", norm_var=True, device="cpu")
    want = jkc.load_wav_dir(t, cmvn="speaker", norm_var=True)
    _same_corpus(got, want, norm_var_gate=True)
    with pytest.raises(ValueError, match="cmvn"):
        tkc.load_wav_dir(t, cmvn="bogus", device="cpu")


@pytest.mark.parametrize("feat_type", ["fbank", "mfcc"])
def test_compute_feats_from_wav_scp_matches(dirs, feat_type):
    from torchain_tpu.data.features import FbankOptions as JOpts
    from torchain_tpu_torch.data.features import FbankOptions

    t, _ = dirs
    kw = dict(sample_rate=8000, num_mel_bins=16)
    args = (str(pathlib.Path(t) / "wav.scp"),)
    seg = str(pathlib.Path(t) / "segments")
    got = tkc.compute_feats_from_wav_scp(*args, FbankOptions(**kw), feat_type,
                                         segments_path=seg, device="cpu")
    want = jkc.compute_feats_from_wav_scp(*args, JOpts(**kw), feat_type, segments_path=seg)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == np.float32
        # MFCC: a 16-point DCT of the log-mel values (row sums of |DCT| < 4)
        np.testing.assert_allclose(got[k], want[k], rtol=0,
                                   atol=2 * TONE_ATOL * (4 if feat_type == "mfcc" else 1))
    with pytest.raises(ValueError, match="feat_type"):
        tkc.compute_feats_from_wav_scp(*args, feat_type="plp", device="cpu")


def test_the_wav_corpus_trains_a_step_on_the_cpu(dirs):
    from torchain_tpu_torch.data import ChainDataset
    from torchain_tpu_torch.graphs import SupervisionOptions
    from torchain_tpu_torch.models import TDNNF, TdnnfConfig
    from torchain_tpu_torch.ops import ChainLossOptions, auto_den_graph
    from torchain_tpu_torch.train import create_train_state, make_train_step

    t, _ = dirs
    corpus = tkc.load_wav_dir(t, cmvn="speaker", device="cpu").corpus
    cfg = TdnnfConfig(num_pdfs=corpus.tree.num_pdfs, hidden_dim=32, bottleneck_dim=8,
                      prefinal_dim=16, num_layers=2)
    left, right = cfg.context
    ds = ChainDataset(corpus.utts, corpus.tree, corpus.norm_fst, chunk_frames_out=8,
                      left_context=left, right_context=right,
                      sup_opts=SupervisionOptions(frame_subsampling_factor=3))
    batch = next(ds.batches(4, shuffle=False))
    model = TDNNF(cfg, corpus.feat_dim, device="cpu",
                  generator=torch.Generator().manual_seed(0))
    step = make_train_step(create_train_state(model, lr=1e-3), ChainLossOptions())
    from torchain_tpu_torch.ops import DeviceSupervision

    sup = DeviceSupervision.from_host(batch.sup, device="cpu").with_kernel_tables()
    den = auto_den_graph(corpus.den_graph, device="cpu")
    losses = [float(step(torch.as_tensor(batch.feats), den, sup)["loss"]) for _ in range(3)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
