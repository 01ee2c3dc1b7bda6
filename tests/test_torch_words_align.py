"""The port's word corpus (data/words.py), symbol tables
(data/kaldi_compat.py) and forced aligner (eval/align.py) on the CPU
against the JAX package's.

The word corpus draws the same lexicon, transcripts and features from a
seed; force_align is the same NumPy DP, held exactly on the same loglikes;
align_corpus runs the port's TDNN-F in torch, its weights carried across
from the JAX model's init (convert.params_from_jax), and must give the JAX
aligner's alignments on the seeded corpus.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax
import jax.numpy as jnp
import torch

from torchain_tpu.data import kaldi_compat as jkc
from torchain_tpu.data import words as jwords
from torchain_tpu.eval import align as jalign
from torchain_tpu.graphs.topology import ContextTree as JTree
from torchain_tpu_torch.data import kaldi_compat as tkc
from torchain_tpu_torch.data import words as twords
from torchain_tpu_torch.eval import align as talign
from torchain_tpu_torch.graphs.topology import ContextTree as TTree


def fst_signature(f):
    return (f.num_states, [(s, a.label, a.weight, a.dst) for s, a in f.all_arcs()],
            [f.final(s) for s in range(f.num_states)])


@pytest.mark.parametrize("kw", [
    dict(num_utts=6, vocab_size=10, num_phones=6, feat_dim=5, seed=3),
    dict(num_utts=5, vocab_size=8, num_phones=7, feat_dim=4, seed=4, context_width=2,
         homophones=True, lm_order=3),
])
def test_synthetic_word_dataset_equals_jax(kw):
    j = jwords.synthetic_word_dataset(**kw)
    t = twords.synthetic_word_dataset(**kw)
    assert t.lexicon.prons == j.lexicon.prons
    assert t.transcripts == j.transcripts
    assert len(t.corpus.utts) == len(j.corpus.utts)
    for tu, ju in zip(t.corpus.utts, j.corpus.utts):
        assert tu.utt_id == ju.utt_id and tu.alignment == ju.alignment
        np.testing.assert_array_equal(tu.feats, ju.feats)
    np.testing.assert_array_equal(t.corpus.pdf_means, j.corpus.pdf_means)
    assert fst_signature(t.corpus.den_fst) == fst_signature(j.corpus.den_fst)


@pytest.mark.parametrize("homophones", [False, True])
def test_random_lexicon_equals_jax(homophones):
    j = jwords.random_lexicon(12, 5, np.random.default_rng(1), max_pron_len=3, homophones=homophones)
    t = twords.random_lexicon(12, 5, np.random.default_rng(1), max_pron_len=3, homophones=homophones)
    assert t.prons == j.prons and (t.sil_phone, t.sil_prob) == (j.sil_phone, j.sil_prob)
    with pytest.raises(ValueError, match="unique"):
        twords.random_lexicon(40, 2, np.random.default_rng(0), max_pron_len=2)


@pytest.mark.parametrize("order", [2, 3])
def test_train_word_lm_equals_jax(order):
    rng = np.random.default_rng(order)
    sents = [[int(w) for w in rng.integers(1, 9, size=int(rng.integers(2, 7)))] for _ in range(30)]
    assert fst_signature(twords.train_word_lm(sents, order=order, extra_states=20)) == \
        fst_signature(jwords.train_word_lm(sents, order=order, extra_states=20))


def test_symbol_tables_equal_jax(tmp_path):
    table = {"<eps>": 0, "a": 1, "bee": 2, "c-d": 7}
    tkc.write_symbol_table(str(tmp_path / "t.txt"), table)
    jkc.write_symbol_table(str(tmp_path / "j.txt"), table)
    assert (tmp_path / "t.txt").read_bytes() == (tmp_path / "j.txt").read_bytes()
    assert tkc.read_symbol_table(str(tmp_path / "t.txt")) == table
    assert tkc.read_phone_table(str(tmp_path / "j.txt")) == jkc.read_phone_table(str(tmp_path / "j.txt"))


@pytest.mark.parametrize("context_width", [1, 2])
def test_force_align_equals_jax(context_width):
    rng = np.random.default_rng(context_width)
    jt, tt = JTree(6, context_width=context_width), TTree(6, context_width=context_width)
    for _ in range(8):
        phones = [int(p) for p in rng.integers(1, 7, size=int(rng.integers(1, 7)))]
        T = len(phones) + int(rng.integers(0, 12))
        y = rng.normal(size=(T, tt.num_pdfs)).astype(np.float32) * 2
        assert talign.force_align(y, phones, tt) == jalign.force_align(y, phones, jt)
    with pytest.raises(ValueError, match="cannot align"):
        talign.force_align(y[:1], [1, 2], tt)
    with pytest.raises(ValueError, match="empty"):
        talign.force_align(y, [], tt)


def test_align_corpus_equals_jax():
    from torchain_tpu.data import synthetic_dataset as jsynth
    from torchain_tpu.models import TDNNF as JTDNNF
    from torchain_tpu.models import TdnnfConfig as JCfg
    from torchain_tpu.train.step import make_forward_fn as jforward
    from torchain_tpu_torch.convert import params_from_jax
    from torchain_tpu_torch.data import synthetic_dataset as tsynth
    from torchain_tpu_torch.models import TDNNF, TdnnfConfig
    from torchain_tpu_torch.train.step import make_forward_fn as tforward

    kw = dict(num_utts=4, num_phones=5, feat_dim=8, utt_frames_out=(12, 20), seed=2)
    jc, tc = jsynth(**kw), tsynth(**kw)
    small = dict(num_pdfs=tc.tree.num_pdfs, hidden_dim=32, bottleneck_dim=8, num_layers=2)
    jcfg, tcfg = JCfg(**small), TdnnfConfig(**small)
    left, right = tcfg.context
    jm = JTDNNF(jcfg)
    example = np.zeros((1, 3 * 12 + left + right, 8), np.float32)
    variables = jm.init(jax.random.PRNGKey(5), jnp.asarray(example), train=False)
    tm = TDNNF(tcfg, 8, device="cpu")
    tm.load_state_dict(params_from_jax(variables["params"], variables["batch_stats"], tcfg))
    ctx = dict(frame_subsampling_factor=3, left_context=left, right_context=right)
    want = jalign.align_corpus(jforward(jm), variables, jc.utts, jc.tree, **ctx)
    got = talign.align_corpus(tforward(tm), tc.utts, tc.tree, **ctx)
    assert got == want
    for u, ali in zip(tc.utts, got):
        assert sum(d for _, d in ali) == u.feats.shape[0]
        assert [p for p, _ in ali] == [p for p, _ in u.alignment]
    assert tforward(tm).device == torch.device("cpu")
