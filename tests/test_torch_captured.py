"""The fixed shapes a captured train step needs (train/captured.py), on the
CPU, where no graph is captured:

  (a) live-arc lists built with an `L_cap` larger than the batch's longest
      list walk like the uncapped lists, exactly: K3's and K4's order over
      the list (the emulations of tests/test_torch_num_resident.py) and
      K8f's and K8b's (tests/test_torch_e2e.py) give the same bits, and
      the JAX package's numerator kernels in interpret mode agree within
      those files' tolerances (rtol/atol 1e-5, -inf in the same places);
  (b) a batch whose list is longer than the cap raises;
  (c) batch B copied into static buffers made from batch A (one set of
      caps, one `L_cap`) gives the JAX chain loss of B within
      tests/test_torch_chain_loss.py's tolerances (rtol 1e-5 on the
      scalars, atol 1e-6 on the gradients), and the eager step through
      those buffers the eager step's metrics on B itself, bit for bit; a
      batch of another shape raises and names the field;
  (d) `make_train_step(capture=True)` raises ValueError for a CPU model,
      under a mesh axis larger than 1 and with dropout.

Sizes are small: the whole file takes a few seconds."""

import copy

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
from tests.test_torch_e2e import emulate_e2e_backward, emulate_e2e_forward
from tests.test_torch_num_resident import (
    _backward_inputs,
    _list_records,
    _list_run,
    _same_where_finite,
    emulate_steady_backward,
    emulate_steady_forward,
)
from tests.test_torch_num_resident import setup  # noqa: F401 (fixture)
from torchain_tpu.ops import num_resident as jnr
from torchain_tpu.ops.den_resident import DeviceResidentDenGraph as JResident
from torchain_tpu.ops.device_graphs import DeviceSupervision as JSup
from torchain_tpu_torch.models import TDNNF, TdnnfConfig
from torchain_tpu_torch.ops import num_resident as tnr
from torchain_tpu_torch.parallel.mesh import Mesh
from torchain_tpu_torch.train import create_train_state, make_train_step
from torchain_tpu_torch.train.captured import copy_inputs_, static_like

CORPUS = dict(num_utts=6, num_phones=4, feat_dim=8, utt_frames_out=(8, 11), seed=5)
OPTS = dict(l2_regularize=5e-4, leaky_hmm_coefficient=0.1, xent_regularize=0.1)
SMALL = dict(hidden_dim=32, bottleneck_dim=8, prefinal_dim=16, num_layers=2)
EXTRA = 5  # columns of the cap past the batch's longest list


def test_capped_steady_lists_walk_like_uncapped(setup):  # noqa: F811
    """(a), K3 and K4: the same offsets, the same records, zeros after; the
    kernels' orders over the capped list give the uncapped list's bits."""
    jsup, tsup, ysmall, alpha1 = setup
    tables = (tsup.in_src_r, tsup.pdf_local_r, tsup.in_logw_r)
    pre = tnr.kernel_tables(*tables)
    L = pre[1].shape[1]
    capped = tnr.kernel_tables(*tables, L_cap=L + EXTRA)
    assert capped[1].shape == (pre[1].shape[0], L + EXTRA, 4)
    assert torch.equal(capped[0], pre[0]) and torch.equal(capped[2], pre[2])
    assert torch.equal(capped[1][:, :L], pre[1]) and (capped[1][:, L:] == 0).all()
    assert tsup.with_kernel_tables(L_cap=L + EXTRA).arcs_k.shape[1] == L + EXTRA

    ysm, a1 = torch.as_tensor(ysmall)[:, 1:], torch.as_tensor(alpha1)
    got = emulate_steady_forward(lambda b, t, s: _list_run(capped, b, t, s), a1, ysm)
    want = emulate_steady_forward(lambda b, t, s: _list_run(pre, b, t, s), a1, ysm)
    assert torch.equal(got, want)
    _, rest_j = jnr.steady_forward(jnp.asarray(alpha1), jsup.in_src_r, jsup.pdf_local_r,
                                   jsup.in_logw_r, jnp.asarray(ysmall[:, 1:]), interpret=True)
    _same_where_finite(got, rest_j)

    ysm, alphas, log_p = _backward_inputs(tsup, ysmall, alpha1)
    args = (ysm, alphas, tsup.final_logw, log_p)
    beta_c, gsm_c = emulate_steady_backward(lambda b, t: _list_records(capped, b, t), *args)
    beta_u, gsm_u = emulate_steady_backward(lambda b, t: _list_records(pre, b, t), *args)
    assert torch.equal(beta_c, beta_u) and torch.equal(gsm_c, gsm_u)
    beta_j, gsm_j = jnr.steady_backward(
        jsup.in_src_r, jsup.pdf_local_r, jsup.in_logw_r, jnp.asarray(ysmall[:, 1:]),
        jnp.asarray(alphas.numpy()), jsup.final_logw, jnp.asarray(log_p.numpy()),
        interpret=True)
    _same_where_finite(beta_c, beta_j)
    np.testing.assert_allclose(gsm_c.numpy(), np.asarray(gsm_j), atol=1e-5)
    # the wrappers on CPU tensors take either list
    for fn, a in ((tnr.steady_forward, (a1,) + tables + (ysm,)),
                  (tnr.steady_backward, tables + args)):
        for x, y in zip(fn(*a, pre=capped), fn(*a, pre=pre)):
            assert torch.equal(x, y)


def _e2e_side(pkg, caps=False):
    c = pkg.synthetic_dataset(**CORPUS)
    ds = pkg.E2eChainDataset(c.utts, c.tree, c.norm_fst, chunk_frames_out=8,
                             left_context=2, right_context=2)
    kw = dict(sup_caps=ds.estimate_e2e_caps()) if caps else {}
    return c, ds, list(ds.batches(3, shuffle=False, **kw))


@pytest.mark.parametrize("extra", [EXTRA, 10**3], ids=["past_the_list", "past_every_slot"])
def test_capped_e2e_lists_walk_like_uncapped(extra):
    """(a), K8f and K8b, with a cap past the longest list and past every
    slot of the tables."""
    _, _, (batch, _) = _e2e_side(tdata)
    _, _, (jbatch, _) = _e2e_side(jdata)
    sup = batch.sup
    src, logw = torch.as_tensor(sup.in_src), torch.as_tensor(sup.in_logw)
    B, S, K = src.shape
    pre = tnr.e2e_kernel_tables(src, logw)
    L = pre[3].shape[1]
    capped = tnr.e2e_kernel_tables(src, logw, L_cap=L + extra)
    for i in (0, 1, 2, 4):
        assert torch.equal(capped[i], pre[i])
    for i in (3, 5):
        assert capped[i].shape == (B, L + extra) and capped[i].dtype == torch.int32
        assert torch.equal(capped[i][:, :L], pre[i])
    assert (capped[3][:, L:] == 0).all() and (capped[5][:, S * K:] == 0).all()

    rng = np.random.default_rng(5)
    T = sup.num_frames
    ylocal = torch.as_tensor(rng.normal(size=(B, T, S, K)).astype(np.float32))
    rest_c, rest_u = emulate_e2e_forward(capped, ylocal), emulate_e2e_forward(pre, ylocal)
    assert torch.equal(rest_c, rest_u)
    a0 = torch.full((1, B, S), -torch.inf)
    a0[:, :, 0] = 0.0
    alphas = torch.cat([a0, rest_c[:-1]])
    final = torch.as_tensor(sup.final_logw)
    log_p = torch.logsumexp(rest_c[-1] + final, dim=-1)
    post_c = emulate_e2e_backward(capped, ylocal, alphas, final, log_p)
    assert torch.equal(post_c, emulate_e2e_backward(pre, ylocal, alphas, final, log_p))
    np.testing.assert_array_equal(np.asarray(jbatch.sup.in_src), sup.in_src)
    rest_j = jnr.e2e_forward_resident(jnp.asarray(ylocal.numpy()), jnp.asarray(jbatch.sup.in_src),
                                      jnp.asarray(jbatch.sup.in_logw), interpret=True)
    _same_where_finite(rest_c, rest_j)
    post_j = jnr.e2e_backward_resident(
        *(jnp.asarray(x.numpy()) for x in (ylocal, alphas, src, logw, final, log_p)),
        interpret=True)
    np.testing.assert_allclose(post_c.numpy(), np.asarray(post_j), rtol=1e-5, atol=1e-5)


def test_a_batch_past_the_cap_raises(setup):  # noqa: F811
    """(b): no list is cut short."""
    _, tsup, _, _ = setup
    L = tsup.arcs_k.shape[1]
    with pytest.raises(ValueError, match=f"more than L_cap {L - 1}"):
        tsup.with_kernel_tables(L_cap=L - 1)
    _, _, (batch, _) = _e2e_side(tdata)
    esup = tops.DeviceE2eSupervision.from_host(batch.sup, device="cpu")
    L = esup.with_kernel_tables().kernel_pre[3].shape[1]
    assert esup.with_kernel_tables(L_cap=L).kernel_pre[3].shape[1] == L
    with pytest.raises(ValueError, match=f"more than L_cap {L - 1}"):
        esup.with_kernel_tables(L_cap=L - 1)
    with pytest.raises(ValueError, match="at least 1"):
        esup.with_kernel_tables(L_cap=0)


def test_e2e_caps_give_one_shape_and_the_same_loss():
    """`estimate_e2e_caps` gives every e2e batch one shape; the padding
    changes no chain loss (rtol 1e-6)."""
    c, ds, capped = _e2e_side(tdata, caps=True)
    _, _, plain = _e2e_side(tdata)
    S, K, Pv, L = ds.estimate_e2e_caps()
    den = tops.auto_den_graph(c.den_graph, pad_to=8, device="cpu")
    rng = np.random.default_rng(3)
    for a, b in zip(capped, plain):
        sa = tops.DeviceE2eSupervision.from_host(a.sup, device="cpu", vocab_cap=Pv)
        sa = sa.with_kernel_tables(L)
        sb = tops.DeviceE2eSupervision.from_host(b.sup, device="cpu").with_kernel_tables()
        assert sa.in_src.shape == (3, S, K) and sa.vocab.shape == (3, Pv)
        assert sa.kernel_pre[3].shape == (3, L)
        y = torch.as_tensor(rng.normal(size=(3, 8, den.num_pdfs)).astype(np.float32))
        la, _ = tops.chain_loss(y, y, den, sa, tops.ChainLossOptions(**OPTS))
        lb, _ = tops.chain_loss(y, y, den, sb, tops.ChainLossOptions(**OPTS))
        np.testing.assert_allclose(float(la), float(lb), rtol=1e-6)


def _chain_side(pkg_data, pkg_graphs):
    c = pkg_data.synthetic_dataset(**CORPUS)
    left, right = TdnnfConfig(num_pdfs=1, **SMALL).context
    ds = pkg_data.ChainDataset(
        c.utts, c.tree, c.norm_fst, chunk_frames_out=8, left_context=left, right_context=right,
        sup_opts=pkg_graphs.SupervisionOptions(left_tolerance=2, right_tolerance=2))
    return c, ds, list(ds.batches(3, shuffle=False, sup_caps=ds.estimate_sup_caps()))


def test_batch_b_through_buffers_of_batch_a_is_batch_b():
    """(c)."""
    c, ds, (a, b) = _chain_side(tdata, tgraphs)
    jc, _, (_, jb) = _chain_side(jdata, jgraphs)
    np.testing.assert_array_equal(jb.feats, b.feats)
    L = ds.estimate_live_arcs()
    sup_a, sup_b = (tops.DeviceSupervision.from_host(x.sup, device="cpu").with_kernel_tables(L)
                    for x in (a, b))
    feats_a, feats_b = torch.as_tensor(a.feats), torch.as_tensor(b.feats)
    static = static_like(feats_a, sup_a)
    copy_inputs_(static, feats_b, sup_b)
    s_feats, s_sup = static
    assert torch.equal(s_feats, feats_b) and torch.equal(s_sup.arcs_k, sup_b.arcs_k)
    assert s_sup.arcs_k.data_ptr() != sup_b.arcs_k.data_ptr()

    # the chain loss of the buffers against the JAX chain loss of B
    tden = tops.auto_den_graph(c.den_graph, pad_to=8, device="cpu")
    jden = JResident.from_host(jc.den_graph, pad_to=8, dtype=jnp.float32)
    jsup = JSup.from_host(jb.sup)
    Bn, T = jb.sup.in_src.shape[:2]
    rng = np.random.default_rng(11)
    y, x = (rng.normal(size=(Bn, T, tden.num_pdfs)).astype(np.float32) for _ in range(2))

    def jloss(y, x):
        return jops.chain_loss(y, x, jden, jsup, jops.ChainLossOptions(**OPTS))

    (l_j, aux_j), (dy_j, dx_j) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(y), jnp.asarray(x))
    yt, xt = torch.tensor(y, requires_grad=True), torch.tensor(x, requires_grad=True)
    l_t, aux_t = tops.chain_loss(yt, xt, tden, s_sup, tops.ChainLossOptions(**OPTS))
    l_t.backward()
    np.testing.assert_allclose(float(l_t.detach()), float(l_j), rtol=1e-5)
    for k in aux_j:
        np.testing.assert_allclose(float(aux_t[k].detach()), float(aux_j[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    np.testing.assert_allclose(yt.grad.numpy(), np.asarray(dy_j), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx_j), rtol=1e-4, atol=1e-6)

    # the eager step through the buffers is the eager step on B
    cfg = TdnnfConfig(num_pdfs=tden.num_pdfs, **SMALL)
    model = TDNNF(cfg, c.feat_dim, device="cpu", generator=torch.Generator().manual_seed(1))
    metrics = []
    for m, inputs in ((model, static), (copy.deepcopy(model), (feats_b, sup_b))):
        step = make_train_step(create_train_state(m), tops.ChainLossOptions(**OPTS))
        metrics.append(step(inputs[0], tden, inputs[1]))
    assert metrics[0].keys() == metrics[1].keys()
    assert all(torch.equal(metrics[0][k], metrics[1][k]) for k in metrics[0])

    # a batch of another shape raises and names the field
    with pytest.raises(ValueError, match="sup.arcs_k"):
        copy_inputs_(static, feats_b, sup_b.with_kernel_tables(L + 1))
    with pytest.raises(ValueError, match="feats"):
        copy_inputs_(static, feats_b[:2], sup_b)
    e2e = tops.DeviceE2eSupervision.from_host(_e2e_side(tdata)[2][0].sup, device="cpu")
    with pytest.raises(ValueError, match="DeviceSupervision"):
        copy_inputs_(static, feats_b, e2e)


@pytest.fixture(scope="module")
def cpu_state():
    model = TDNNF(TdnnfConfig(num_pdfs=8, **SMALL), 8, device="cpu",
                  generator=torch.Generator().manual_seed(0))
    return create_train_state(model)


@pytest.mark.parametrize("case", ["cpu_model", "mesh_data", "mesh_model", "dropout"])
def test_capture_refuses_what_stays_eager(cpu_state, case):
    """(d): a ValueError, never a quiet eager step."""
    kw, match = {
        "cpu_model": ({}, "on cpu"),
        "mesh_data": (dict(mesh=Mesh(shape={"data": 2, "model": 1})), "data 2 x model 1"),
        "mesh_model": (dict(mesh=Mesh(shape={"data": 1, "model": 2})), "data 1 x model 2"),
        "dropout": (dict(dropout=True), "dropout"),
    }[case]
    with pytest.raises(ValueError, match=match):
        make_train_step(cpu_state, tops.ChainLossOptions(**OPTS), capture=True, **kw)


def test_capturable_adam_is_for_the_card():
    model = TDNNF(TdnnfConfig(num_pdfs=8, **SMALL), 8, device="cpu")
    with pytest.raises(ValueError, match="on cpu"):
        create_train_state(model, capturable=True)
