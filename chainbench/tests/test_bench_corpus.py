"""The frozen corpus generator against the program's own generator pieces
(the same phone LM, denominator HMM, tree and chunks from the same
inputs), and its determinism in the seed."""

from __future__ import annotations

import numpy as np
import pytest

from chainbench import program
from chainbench.corpus import Tree, estimate_phone_lm, expand_biphone, make_corpus
from chainbench.tests.conftest import CORPUS
from torchain_tpu_torch.graphs import ContextTree, PhoneLmOptions, make_den_fst
from torchain_tpu_torch.graphs import estimate_phone_lm as port_lm

CFG = dict(CORPUS, frame_subsampling_factor=3, phone_durations_out=[1, 5], feat_dim=12,
           lm_order=4, lm_no_prune_order=2, pdf_mean_scale=2.0, feature_noise=0.5)


def _arcs(fst_arcs):
    return sorted(fst_arcs)


@pytest.mark.parametrize("seed", [0, 2**31 + 5, 2**40 + 3])
def test_the_same_seed_makes_the_same_corpus(seed):
    a, b = make_corpus(seed, CFG, 10, 20), make_corpus(seed, CFG, 10, 20)
    assert all(np.array_equal(x, y) for x, y in zip(a.feats, b.feats))
    assert np.array_equal(a.den.src, b.den.src) and np.array_equal(a.den.logw, b.den.logw)
    assert [c.ali for c in a.chunks] == [c.ali for c in b.chunks]
    c = make_corpus(seed + 1, CFG, 10, 20)
    assert not np.array_equal(a.feats[0], c.feats[0])
    # another seed: the same graph and utterances, in another order
    assert np.array_equal(a.den.src, c.den.src) and np.array_equal(a.den.logw, c.den.logw)
    assert sorted(map(repr, a.alignments)) == sorted(map(repr, c.alignments))
    assert list(map(repr, a.alignments)) != list(map(repr, c.alignments))


def test_the_tree_is_the_programs_left_biphone_tree():
    tree, port = Tree(7), ContextTree(7, context_width=2)
    assert tree.num_pdfs == port.num_pdfs
    for phone in range(1, 8):
        for cls in (0, 1):
            for left in range(8):
                assert tree.pdf(phone, cls, left) == port.pdf(phone, cls, left)


@pytest.mark.parametrize("order,extra", [(2, 5), (3, 30), (4, 200)])
def test_the_lm_and_hmm_are_the_programs(order, extra):
    rng = np.random.default_rng(order)
    sents = [list(rng.integers(1, 7, size=rng.integers(3, 15))) for _ in range(40)]
    lm = estimate_phone_lm(sents, order, extra)
    plm = port_lm(sents, PhoneLmOptions(ngram_order=order, num_extra_lm_states=extra))
    assert lm.num_states == plm.num_states
    assert _arcs(zip(lm.src.tolist(), lm.label.tolist(), lm.logw.tolist(), lm.dst.tolist())) == \
        _arcs((s, a.label, a.weight, a.dst) for s, a in plm.all_arcs())
    den = expand_biphone(lm, Tree(6))
    pden = make_den_fst(plm, ContextTree(6, context_width=2))
    assert den.num_states == pden.num_states
    assert _arcs(zip(den.src.tolist(), (den.label + 1).tolist(), den.logw.tolist(),
                     den.dst.tolist())) == _arcs((s, a.label, a.weight, a.dst)
                                                  for s, a in pden.all_arcs())


def test_the_chunks_are_the_loaders(tiny):
    cell = tiny("tdnnf")
    corpus = make_corpus(123, cell.config["corpus"], 10, 24)
    graph, norm, tree = program.host_graphs(corpus)
    ds = program.chain_dataset(corpus, norm, tree, cell.traffic, (3, 4))
    mine = [(c.utt, c.c0, c.ali, c.left, c.right) for c in corpus.chunks]
    assert mine == [(u, c0, ali, lc, rc) for u, c0, _t, ali, lc, rc in ds.chunks][:len(mine)]
    feats = next(ds.batches(4, shuffle=False)).feats
    ref = np.stack([corpus.chunk_feats(c, 10, 3, 4) for c in corpus.chunks[:4]])
    assert np.array_equal(feats, ref)
