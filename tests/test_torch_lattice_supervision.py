"""The port's lattice supervision (torchain_tpu_torch/graphs/
lattice_supervision.py) against the JAX package's: the supervision FSTs of
linear, sausage and branching phone lattices (arcs, weights and finals
equal), and the chain loss of a batch of them, composed with a corpus's
normalization FST, on the port's resident denominator against the JAX
package's chain_loss (Pallas kernels in interpret mode on the CPU).

Tolerance of the loss: that of tests/test_torch_chain_loss.py (rtol 1e-5 on
the scalars, atol 1e-6 on the gradients)."""

import math

import numpy as np
import pytest

pytest.importorskip("jax")

import jax
import jax.numpy as jnp
import torch

import torchain_tpu.data as jdata
import torchain_tpu.graphs as jgraphs
import torchain_tpu.ops as jops
import torchain_tpu_torch.data as tdata
import torchain_tpu_torch.graphs as tgraphs
import torchain_tpu_torch.ops as tops
from torchain_tpu.fstkit import compose as jcompose
from torchain_tpu.graphs.supervision import pad_and_stack_supervisions as jstack
from torchain_tpu.ops.den_resident import DeviceResidentDenGraph as JResident
from torchain_tpu.ops.device_graphs import DeviceSupervision as JSup
from torchain_tpu_torch.fstkit import compose as tcompose
from torchain_tpu_torch.graphs.supervision import pad_and_stack_supervisions as tstack
from torchain_tpu_torch.ops.den_resident import DeviceResidentDenGraph as TResident
from torchain_tpu_torch.ops.device_graphs import DeviceSupervision as TSup

OPTS = dict(l2_regularize=5e-4, leaky_hmm_coefficient=0.1, xent_regularize=0.1)
#: a bigram phone LM over enough utterances to accept every phone sequence of
#: the lattices below
CORPUS = dict(num_utts=40, num_phones=4, feat_dim=8, utt_frames_out=(9, 12), seed=3,
              context_width=2, lm_order=2, lm_extra_states=30)
T = 9


def lattices(pkg):
    """(name, lattice) of each kind, built by graphs package `pkg`, all of
    T frames over 4 phones."""
    L = pkg.PhoneLattice
    rng = np.random.default_rng(5)
    ali = [(int(rng.integers(1, 5)), d) for d in (3, 2, 4)]
    return [
        ("linear", L.from_alignment(ali)),
        ("sausage", L.from_sausage([[(1, 0.6), (2, 0.4)], [(3, 1.0)], [(4, 0.3), (1, 0.7)]],
                                   durations=[3, 3, 3])),
        ("unnormalized", L.from_sausage([[(2, 2.0), (4, 0.5)], [(1, 1.5)]], durations=[4, 5],
                                        normalize=False)),
        ("branching", L(num_nodes=5,
                        arcs=[(0, 1, 1, math.log(0.5)), (0, 2, 2, math.log(0.5)),
                              (1, 3, 3, 0.0), (2, 3, 1, 0.0), (3, 4, 4, math.log(0.9)),
                              (2, 4, 3, math.log(0.1))],
                        times=[0, 3, 3, 6, 9], finals={4})),
    ]


def _arcs(fst):
    return [(s, a.label, a.weight, a.dst) for s, a in fst.all_arcs()]


@pytest.mark.parametrize("context_width", [1, 2])
@pytest.mark.parametrize("tol", [(0, 0), (1, 1), (2, 1)])
def test_supervision_fsts_equal_jax(context_width, tol):
    jt = jgraphs.ContextTree(4, context_width=context_width)
    tt = tgraphs.ContextTree(4, context_width=context_width)
    jo, to = jgraphs.SupervisionOptions(*tol), tgraphs.SupervisionOptions(*tol)
    for (name, jl), (_, tl) in zip(lattices(jgraphs), lattices(tgraphs)):
        for left in (0, 3):
            jf = jgraphs.lattice_to_supervision_fst(jl, jt, jo, left_context_phone=left)
            tf = tgraphs.lattice_to_supervision_fst(tl, tt, to, left_context_phone=left)
            assert tf.num_states == jf.num_states, name
            assert _arcs(tf) == _arcs(jf), name
            assert [tf.final(s) for s in range(tf.num_states)] == [
                jf.final(s) for s in range(jf.num_states)], name


def test_infeasible_lattice_raises_as_in_jax():
    lat = tgraphs.PhoneLattice.from_sausage([[(1, 1.0)], [(2, 1.0)]], [1, 1])
    with pytest.raises(ValueError):
        tgraphs.lattice_to_supervision_fst(lat, tgraphs.ContextTree(2),
                                           tgraphs.SupervisionOptions(0, 0), num_frames=1)
    with pytest.raises(ValueError):
        tgraphs.PhoneLattice.from_sausage([[(1, 1.0)]], [0])


def _batch(pkg_data, pkg_graphs, compose, stack):
    c = pkg_data.synthetic_dataset(**CORPUS)
    sups = [
        pkg_graphs.compile_supervision(
            compose(pkg_graphs.lattice_to_supervision_fst(
                lat, c.tree, pkg_graphs.SupervisionOptions(1, 1)), c.norm_fst),
            c.tree.num_pdfs)
        for _, lat in lattices(pkg_graphs)
    ]
    return c.den_graph, stack(sups)


def test_chain_loss_on_lattice_supervision_matches_jax():
    (jg, jb), (tg, tb) = (_batch(jdata, jgraphs, jcompose, jstack),
                          _batch(tdata, tgraphs, tcompose, tstack))
    for name in ("in_src", "in_logw", "final_logw", "weight"):
        np.testing.assert_array_equal(getattr(tb, name), getattr(jb, name), err_msg=name)
    B = jb.in_src.shape[0]
    assert jb.in_src.shape[1] == T
    rng = np.random.default_rng(13)
    y = rng.normal(size=(B, T, jg.num_pdfs)).astype(np.float32)
    x = rng.normal(size=(B, T, jg.num_pdfs)).astype(np.float32)
    jden = JResident.from_host(jg, pad_to=8, dtype=jnp.float32)
    tden = TResident.from_host(tg, pad_to=8, device="cpu")
    jsup, tsup = JSup.from_host(jb), TSup.from_host(tb, device="cpu")

    def jloss(y, x):
        return jops.chain_loss(y, x, jden, jsup, jops.ChainLossOptions(**OPTS))

    (l_j, aux_j), (dy_j, dx_j) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(y), jnp.asarray(x))
    yt = torch.tensor(y, requires_grad=True)
    xt = torch.tensor(x, requires_grad=True)
    l_t, aux_t = tops.chain_loss(yt, xt, tden, tsup, tops.ChainLossOptions(**OPTS))
    l_t.backward()
    np.testing.assert_allclose(float(l_t.detach()), float(l_j), rtol=1e-5)
    assert set(aux_t) == set(aux_j)
    for k in aux_j:
        np.testing.assert_allclose(float(aux_t[k].detach()), float(aux_j[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    assert float(aux_t["num_failed"]) == 0.0
    np.testing.assert_allclose(yt.grad.numpy(), np.asarray(dy_j), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx_j), rtol=1e-4, atol=1e-6)
