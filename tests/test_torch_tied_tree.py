"""The port's tied context trees (torchain_tpu_torch/graphs/tied_tree.py) and
the triphone expansion of graphs/den_graph.py against the JAX package's:
`accumulate_tree_stats`, `build_tied_tree` (the port caches each group's
pair losses; its pdf map must equal the JAX loop's exactly), the Kaldi tree
text format, and the triphone den graph, decoding graph and word HCLG that a
tied tree gives.

Corpora are drawn from a seed with NumPy at the JAX tests' sizes
(tests/test_triphone.py: 4 phones, frame subsampling 2; tests/
test_tied_tree.py).  The JAX `build_tied_tree` costs the cube of a group's
cells, so no case here gives it more than a few hundred cells."""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")

from torchain_tpu.eval import decoder as jdec
from torchain_tpu.graphs import den_graph as jden
from torchain_tpu.graphs import hclg as jhclg
from torchain_tpu.graphs import tied_tree as jtt
from torchain_tpu.graphs.phone_lm import PhoneLmOptions as JLmOpts
from torchain_tpu.graphs.phone_lm import estimate_phone_lm as jestimate
from torchain_tpu_torch.data import Utterance
from torchain_tpu_torch.eval import decoder as tdec
from torchain_tpu_torch.graphs import den_graph as tden
from torchain_tpu_torch.graphs import hclg as thclg
from torchain_tpu_torch.graphs import tied_tree as ttt
from torchain_tpu_torch.graphs.phone_lm import PhoneLmOptions as TLmOpts
from torchain_tpu_torch.graphs.phone_lm import estimate_phone_lm as p_estimate

FSF = 2


def corpus(num_phones=4, n=60, feat_dim=10, seed=0, noise=0.12):
    """tests/test_triphone.py's corpus: features whose means depend on
    (left, phone, right) and the pdf class; returns (utterances, phone
    sentences)."""
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(num_phones + 1, 2, feat_dim)) * 2.5
    lshift = rng.normal(size=(num_phones + 1, feat_dim)) * 1.2
    rshift = rng.normal(size=(num_phones + 1, feat_dim)) * 1.2
    utts, sents = [], []
    for u in range(n):
        phones = [int(x) for x in rng.integers(1, num_phones + 1, size=rng.integers(4, 9))]
        sents.append(phones)
        feats, ali = [], []
        for i, q in enumerate(phones):
            left = phones[i - 1] if i > 0 else 0
            right = phones[i + 1] if i + 1 < len(phones) else 0
            d_in = int(rng.integers(1, 4)) * FSF
            ali.append((q, d_in))
            for j in range(d_in):
                m = base[q, 0 if j < FSF else 1] + 0.8 * lshift[left] + 0.8 * rshift[right]
                feats.append(m + rng.normal(size=feat_dim) * noise)
        utts.append(Utterance(feats=np.asarray(feats, np.float32), alignment=ali,
                              utt_id=f"utt{u}"))
    return utts, sents


def stats_pair(context, seed, num_phones=4, n=60):
    utts, sents = corpus(num_phones=num_phones, n=n, seed=seed)
    kw = dict(frame_subsampling_factor=FSF, context=context)
    return (jtt.accumulate_tree_stats(utts, num_phones, **kw),
            ttt.accumulate_tree_stats(utts, num_phones, **kw), sents)


@pytest.mark.parametrize("context", ["left", "triphone"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_accumulate_tree_stats_equals_jax(context, seed):
    j, t, _ = stats_pair(context, seed)
    for name in ("count", "sum", "sumsq"):
        a, b = getattr(t, name), getattr(j, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert t.num_phones == j.num_phones and t.feat_dim == j.feat_dim


@pytest.mark.parametrize("min_count", [0.0, 4.0])
@pytest.mark.parametrize("context", ["left", "triphone"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_build_tied_tree_pdf_map_equals_jax(context, seed, min_count):
    j, t, _ = stats_pair(context, seed)
    cells = int((j.count > 0).sum())
    groups = j.count.shape[0] * j.num_phones
    for budget in (groups, (groups + cells) // 2, cells - 1, cells + 5):
        want = jtt.build_tied_tree(j, budget, min_count=min_count)
        got = ttt.build_tied_tree(t, budget, min_count=min_count)
        assert got.pdf_map.dtype == want.pdf_map.dtype
        np.testing.assert_array_equal(got.pdf_map, want.pdf_map, err_msg=f"budget {budget}")
        assert got.num_pdfs == want.num_pdfs == min(budget, cells)
    with pytest.raises(ValueError):
        ttt.build_tied_tree(t, groups - 1)


def test_build_tied_tree_pdf_map_equals_jax_on_hundreds_of_cells():
    """A triphone corpus of 6 phones: some 300 cells in 12 groups, where
    many near ties meet; a few seconds of the JAX loop."""
    j, t, _ = stats_pair("triphone", 3, num_phones=6, n=40)
    cells = int((j.count > 0).sum())
    assert cells >= 300
    want = jtt.build_tied_tree(j, 30)
    got = ttt.build_tied_tree(t, 30)
    np.testing.assert_array_equal(got.pdf_map, want.pdf_map)
    assert got.right_dependent(0) or got.right_dependent(1)


HANDWRITTEN = (
    "ContextDependency 2 1 ToPdf TE -1 2 ( "
    "TE 1 3 ( NULL SE 0 [ 1 ] { CE 0 CE 1 } CE 2 ) "
    "TE 1 3 ( NULL CE 3 CE 4 ) "
    ") EndContextDependency"
)
TRIPHONE = (
    "ContextDependency 3 1 ToPdf TE -1 1 ( "
    "TE 1 2 ( NULL SE 2 [ 1 ] { CE 0 CE 1 } ) "
    ") EndContextDependency"
)


@pytest.mark.parametrize("text,num_phones", [(HANDWRITTEN, 2), (HANDWRITTEN, None),
                                             (TRIPHONE, 1), (TRIPHONE, None)])
def test_read_kaldi_tree_equals_jax(text, num_phones):
    j = jtt.read_kaldi_tree(text, num_phones=num_phones)
    t = ttt.read_kaldi_tree(text, num_phones=num_phones)
    np.testing.assert_array_equal(t.pdf_map, j.pdf_map)
    assert (t.num_phones, t.num_pdfs, t.right_size) == (j.num_phones, j.num_pdfs, j.right_size)
    assert ttt.write_kaldi_tree(t) == jtt.write_kaldi_tree(j)


@pytest.mark.parametrize("context", ["left", "triphone"])
def test_write_kaldi_tree_text_equals_jax_and_reads_back(context, tmp_path):
    j, t, _ = stats_pair(context, 4)
    jt, tt = jtt.build_tied_tree(j, 20), ttt.build_tied_tree(t, 20)
    text = ttt.write_kaldi_tree(tt)
    assert text == jtt.write_kaldi_tree(jt)
    path = tmp_path / "tree.txt"
    path.write_text(text)
    back = ttt.read_kaldi_tree(str(path))
    np.testing.assert_array_equal(back.pdf_map, tt.pdf_map)
    np.testing.assert_array_equal(back.pdf_map, jtt.read_kaldi_tree(text).pdf_map)


def triphone_graphs(seed=0, num_pdfs=40):
    """The triphone tree of tests/test_triphone.py and the phone LM of its
    sentences, each built by each package."""
    j, t, sents = stats_pair("triphone", seed)
    out = []
    for tt, stats, est, opts in ((jtt, j, jestimate, JLmOpts), (ttt, t, p_estimate, TLmOpts)):
        tree = tt.build_tied_tree(stats, num_pdfs=num_pdfs)
        out.append((tree, est(sents, opts(ngram_order=2, num_extra_lm_states=40))))
    return out


def _arcs(fst):
    return [(s, a.label, a.weight, a.dst) for s, a in fst.all_arcs()]


def _finals(fst):
    return [fst.final(s) for s in range(fst.num_states)]


@pytest.mark.parametrize("seed", [0, 1])
def test_triphone_den_fst_and_den_graph_equal_jax(seed):
    (jtree, jlm), (ttree, tlm) = triphone_graphs(seed)
    assert ttree.right_dependent(0) or ttree.right_dependent(1)
    jf, jol = jden.expand_lm_to_hmm(jlm, jtree)
    tf, tol = tden.expand_lm_to_hmm(tlm, ttree)
    assert tol == jol and _arcs(tf) == _arcs(jf) and _finals(tf) == _finals(jf)
    jfst, tfst = jden.make_den_fst(jlm, jtree), tden.make_den_fst(tlm, ttree)
    assert tfst.num_states == jfst.num_states and _arcs(tfst) == _arcs(jfst)
    jg = jden.compile_den_graph(jfst, jtree.num_pdfs)
    tg = tden.compile_den_graph(tfst, ttree.num_pdfs)
    for f in dataclasses.fields(jden.DenGraph):
        a, b = getattr(tg, f.name), getattr(jg, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), f.name
        else:
            assert a == b, f.name
    jn = jden.make_normalization_fst(jfst, jg.initial_probs)
    tn = tden.make_normalization_fst(tfst, tg.initial_probs)
    assert _arcs(tn) == _arcs(jn) and _finals(tn) == _finals(jn)


def test_triphone_decoding_graph_equals_jax():
    (jtree, jlm), (ttree, tlm) = triphone_graphs(5)
    j, t = jdec.make_decoding_graph(jlm, jtree), tdec.make_decoding_graph(tlm, ttree)
    for f in dataclasses.fields(jdec.DecodingGraph):
        a, b = getattr(t, f.name), getattr(j, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), f.name
        else:
            assert a == b, f.name
    y = np.random.default_rng(0).normal(size=(20, t.num_pdfs)).astype(np.float32)
    assert tdec.viterbi_decode(t, y)[0] == jdec.viterbi_decode(j, y)[0]


@pytest.mark.parametrize("sil_phone", [0, 4])
def test_triphone_hclg_equals_jax(sil_phone):
    """`make_hclg` over a triphone TiedTree (its cross-word branch,
    `_make_hclg_triphone`) and the packed word graph."""
    (jtree, _), (ttree, _) = triphone_graphs(6)
    rng = np.random.default_rng(6)
    prons = {w: [tuple(int(q) for q in rng.integers(1, 5, size=int(rng.integers(1, 4))))]
             for w in range(1, 7)}
    prons[2].append((1, 2))
    sents = [[int(x) for x in rng.integers(1, 7, size=int(rng.integers(2, 6)))] for _ in range(30)]
    out = []
    for est, opts, hc, tree in ((jestimate, JLmOpts, jhclg, jtree),
                                (p_estimate, TLmOpts, thclg, ttree)):
        g = est(sents, opts(ngram_order=2, num_extra_lm_states=40))
        lex = hc.Lexicon(prons=prons, sil_phone=sil_phone, sil_prob=0.3)
        out.append((g, lex, tree, hc))
    (jg, jlex, jt, jhc), (tg, tlex, tt, thc) = out
    jf, jol = jhc.make_hclg(jg, jlex, jt, lm_scale=0.8)
    tf, tol = thc.make_hclg(tg, tlex, tt, lm_scale=0.8)
    assert tol == jol and tf.num_states == jf.num_states
    assert _arcs(tf) == _arcs(jf) and _finals(tf) == _finals(jf)
    a = jdec.make_word_decoding_graph(jg, jlex, jt)
    b = tdec.make_word_decoding_graph(tg, tlex, tt)
    for f in dataclasses.fields(jdec.DecodingGraph):
        x, y = getattr(b, f.name), getattr(a, f.name)
        if isinstance(y, np.ndarray):
            assert np.array_equal(x, y), f.name
        else:
            assert x == y, f.name
