"""The chain loss of the PyTorch port (ops/chain_loss.py) against the JAX
package's chain_loss on the same resident denominator graph (Pallas kernels
in interpret mode on the CPU), the same supervision batch and the same
numpy outputs: the loss, every aux value, and the gradients with respect to
both heads' outputs.

Tolerance: rtol 1e-5 on the scalars, atol 1e-6 on the gradients (which are
occupancy differences divided by the frame count, ~1e-2 each): float32 on
both sides, sums in another order."""

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
from torchain_tpu.ops.den_resident import DeviceResidentDenGraph as JResident
from torchain_tpu.ops.device_graphs import DeviceSupervision as JSup
from torchain_tpu_torch.ops.den_resident import DeviceResidentDenGraph as TResident
from torchain_tpu_torch.ops.device_graphs import DeviceSupervision as TSup

CORPUS = dict(num_utts=6, num_phones=4, feat_dim=8, utt_frames_out=(9, 12), seed=6,
              lm_order=3, lm_extra_states=30)
OPTS = dict(l2_regularize=5e-4, leaky_hmm_coefficient=0.1, xent_regularize=0.1)


#: the production configuration's kind of graph (left-biphone tree, 4-gram
#: phone LM with extra states) at toy size
BIPHONE_4GRAM = dict(num_utts=8, num_phones=5, feat_dim=8, utt_frames_out=(9, 12), seed=4,
                     context_width=2, lm_order=4, lm_extra_states=40)


def _side(pkg_data, pkg_graphs, B=3, T=9, corpus=CORPUS):
    c = pkg_data.synthetic_dataset(**corpus)
    ds = pkg_data.ChainDataset(
        c.utts, c.tree, c.norm_fst, chunk_frames_out=T, left_context=2,
        right_context=2,
        sup_opts=pkg_graphs.SupervisionOptions(left_tolerance=2, right_tolerance=2),
    )
    return c.den_graph, next(ds.batches(B, shuffle=False)).sup


CASES = ["plain", "frame_weights", "failed_sequence"]


@pytest.fixture(scope="module", params=CASES)
def case(request):
    (jg, jb), (tg, tb) = _side(jdata, jgraphs), _side(tdata, tgraphs)
    B, T = jb.in_src.shape[:2]
    rng = np.random.default_rng(11)
    P = jg.num_pdfs
    for b in (jb, tb):
        if request.param == "frame_weights":
            b.frame_weights = rng.random(size=(B, T)).astype(np.float32)
            rng = np.random.default_rng(11)
        if request.param == "failed_sequence":
            b.final_logw = b.final_logw.copy()
            b.final_logw[0] = -np.inf
    y = rng.normal(size=(B, T, P)).astype(np.float32)
    # one element past the out-of-range limit exercises that term
    y[0, 0, 0] = 31.5
    x = rng.normal(size=(B, T, P)).astype(np.float32)
    jden = JResident.from_host(jg, pad_to=8, dtype=jnp.float32)
    tden = TResident.from_host(tg, pad_to=8, device="cpu")
    return request.param, (jden, JSup.from_host(jb)), (tden, TSup.from_host(tb, device="cpu")), y, x


def test_chain_loss_matches_jax(case):
    name, (jden, jsup), (tden, tsup), y, x = case

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
        np.testing.assert_allclose(float(aux_t[k].detach()), float(aux_j[k]), rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    np.testing.assert_allclose(yt.grad.numpy(), np.asarray(dy_j), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx_j), rtol=1e-4, atol=1e-6)
    if name == "failed_sequence":
        assert float(aux_t["num_failed"]) == 1.0
        # the failed sequence keeps only the l2 gradient
        np.testing.assert_allclose(
            yt.grad[0].numpy(), (5e-4 * yt[0] / float(aux_t["weight"])).detach().numpy()
            + np.where(np.abs(y[0]) > 30, 0.01 * 2 * (np.abs(y[0]) - 30) * np.sign(y[0])
                       / float(aux_t["weight"]), 0.0),
            rtol=1e-4, atol=1e-7)
    else:
        assert float(aux_t["num_failed"]) == 0.0


@pytest.mark.parametrize("resident", ["0", "force"])
def test_biphone_4gram_chain_loss_matches_jax(monkeypatch, resident):
    """A left-biphone, 4-gram corpus through the host tables, the den
    packing and the loss on both sides, under both numerator configurations
    of the JAX package (XLA scan; resident Pallas kernels in interpret
    mode).  Host tables and the packed V are equal exactly; the loss and
    gradients to the tolerances of test_chain_loss_matches_jax."""
    monkeypatch.setenv("TORCHAIN_NUM_RESIDENT", resident)
    (jg, jb), (tg, tb) = (_side(jdata, jgraphs, corpus=BIPHONE_4GRAM),
                          _side(tdata, tgraphs, corpus=BIPHONE_4GRAM))
    for name in ("in_src", "in_logw", "final_logw", "frame_vocab", "pdf_local"):
        np.testing.assert_array_equal(getattr(tb, name), getattr(jb, name), err_msg=name)
    jden = JResident.from_host(jg, pad_to=8, dtype=jnp.float32)
    tden = TResident.from_host(tg, pad_to=8, device="cpu")
    assert tden.num_slots == jden.num_slots == 2 and tden.num_pdfs == jg.num_pdfs
    np.testing.assert_array_equal(tden.V.numpy(), np.asarray(jden.V))
    jsup = JSup.from_host(jb).with_kernel_tables()
    tsup = TSup.from_host(tb, device="cpu").with_kernel_tables()
    assert tsup.steady_arcs == jsup.steady_arcs < tsup.max_arcs
    B, T = jb.in_src.shape[:2]
    rng = np.random.default_rng(12)
    y = rng.normal(size=(B, T, jg.num_pdfs)).astype(np.float32)
    x = rng.normal(size=(B, T, jg.num_pdfs)).astype(np.float32)

    def jloss(y, x):
        return jops.chain_loss(y, x, jden, jsup, jops.ChainLossOptions(**OPTS))

    (l_j, aux_j), (dy_j, dx_j) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(y), jnp.asarray(x))
    yt = torch.tensor(y, requires_grad=True)
    xt = torch.tensor(x, requires_grad=True)
    l_t, aux_t = tops.chain_loss(yt, xt, tden, tsup, tops.ChainLossOptions(**OPTS))
    l_t.backward()
    np.testing.assert_allclose(float(l_t.detach()), float(l_j), rtol=1e-5)
    for k in aux_j:
        np.testing.assert_allclose(float(aux_t[k].detach()), float(aux_j[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    assert float(aux_t["num_failed"]) == 0.0
    np.testing.assert_allclose(yt.grad.numpy(), np.asarray(dy_j), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx_j), rtol=1e-4, atol=1e-6)


def test_chain_results_accumulates():
    r = tops.ChainResults()
    r.add(dict(objf=torch.tensor(-1.0), l2_term=torch.tensor(-0.1),
               xent_objf=torch.tensor(-2.0), weight=torch.tensor(10.0),
               num_failed=torch.tensor(1.0)))
    r.add(dict(objf=-3.0, l2_term=0.0, xent_objf=0.0, weight=30.0))
    assert r.objf == pytest.approx(-2.5)
    assert r.steps == 2 and r.tot_failed == 1.0
    assert "failed_seqs=1" in str(r)
