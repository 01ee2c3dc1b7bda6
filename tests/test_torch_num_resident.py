"""Resident numerator of the PyTorch port (ops/num_resident.py): the plain
versions of kernels K3 (`steady_forward`) and K4 (`steady_backward`), and
the wrappers on CPU tensors with and without placed tables, against the JAX
package's Pallas kernels in interpret mode on the same steady tables,
emissions and alpha of frame 1.

Tolerance: alpha and beta rtol 1e-5 + atol 1e-5 where finite, with the same
-inf entries; occupancies atol 1e-5 (float32 log-sum-exps of a few terms
per state, reduced in another order).  The impossible sequence (no final
state) has exactly zero occupancies on both sides."""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp
import torch

import torchain_tpu.data as jdata
import torchain_tpu.graphs as jgraphs
import torchain_tpu_torch.data as tdata
import torchain_tpu_torch.graphs as tgraphs
from torchain_tpu.ops import num_resident as jnr
from torchain_tpu.ops.device_graphs import DeviceSupervision as JSup
from torchain_tpu_torch.ops import num_resident as tnr
from torchain_tpu_torch.ops.device_graphs import DeviceSupervision as TSup

CORPORA = {
    "monophone_bigram": dict(num_utts=6, num_phones=4, feat_dim=8, utt_frames_out=(8, 11),
                             seed=5),
    "biphone_4gram": dict(num_utts=8, num_phones=5, feat_dim=8, utt_frames_out=(8, 11),
                          seed=3, context_width=2, lm_order=4, lm_extra_states=40),
}
BAD = 1  # the sequence made impossible


def _batch(pkg_data, pkg_graphs, corpus, B=4, T=8):
    c = pkg_data.synthetic_dataset(**corpus)
    ds = pkg_data.ChainDataset(
        c.utts, c.tree, c.norm_fst, chunk_frames_out=T, left_context=2,
        right_context=2,
        sup_opts=pkg_graphs.SupervisionOptions(left_tolerance=2, right_tolerance=2),
    )
    sup = next(ds.batches(B, shuffle=False)).sup
    sup.final_logw = sup.final_logw.copy()
    sup.final_logw[BAD] = -np.inf
    return sup


@pytest.fixture(scope="module", params=sorted(CORPORA))
def setup(request):
    corpus = CORPORA[request.param]
    jsup = JSup.from_host(_batch(jdata, jgraphs, corpus)).with_kernel_tables()
    tsup = TSup.from_host(_batch(tdata, tgraphs, corpus), device="cpu").with_kernel_tables()
    B, T, W = tsup.frame_vocab.shape
    ysmall = np.random.default_rng(7).normal(size=(B, T, W)).astype(np.float32)
    a0 = torch.full((B, tsup.max_states), -np.inf)
    a0[:, 0] = 0.0
    alpha1 = tnr.forward_step(
        a0, torch.as_tensor(ysmall[:, 0]), tsup.in_src0, tsup.pdf_local0, tsup.in_logw0
    ).numpy()
    return jsup, tsup, ysmall, alpha1


def _same_where_finite(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    assert fin.any() and not np.isnan(got).any()
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5, atol=1e-5)


def _torch_forward(how, tsup, ysm, alpha1):
    args = (torch.as_tensor(alpha1), tsup.in_src_r, tsup.pdf_local_r, tsup.in_logw_r, ysm)
    if how == "plain":
        return tnr.steady_forward_plain(*args)
    return tnr.steady_forward(*args, pre=tsup.kernel_pre if how == "wrapper_pre" else None)


def _torch_backward(how, tsup, ysm, alphas, log_p):
    args = (tsup.in_src_r, tsup.pdf_local_r, tsup.in_logw_r, ysm, alphas,
            tsup.final_logw, log_p)
    if how == "plain":
        return tnr.steady_backward_plain(*args)
    return tnr.steady_backward(*args, pre=tsup.kernel_pre if how == "wrapper_pre" else None)


HOW = ["plain", "wrapper", "wrapper_pre"]


@pytest.mark.parametrize("how", HOW)
def test_steady_forward_matches_pallas(setup, how):
    jsup, tsup, ysmall, alpha1 = setup
    aT_j, rest_j = jnr.steady_forward(
        jnp.asarray(alpha1), jsup.in_src_r, jsup.pdf_local_r, jsup.in_logw_r,
        jnp.asarray(ysmall[:, 1:]), interpret=True,
        pre=(jsup.src_k, jsup.pdf_local_k, jsup.logw_k) if how == "wrapper_pre" else None,
    )
    n = tnr.steady_forward.launches
    aT_t, rest_t = _torch_forward(how, tsup, torch.as_tensor(ysmall)[:, 1:], alpha1)
    assert rest_t.shape == (ysmall.shape[1] - 1,) + alpha1.shape
    _same_where_finite(rest_t, rest_j)
    _same_where_finite(aT_t, aT_j)
    assert torch.equal(aT_t, rest_t[-1])
    # on a CPU tensor no kernel is launched
    assert tnr.steady_forward.launches == n


@pytest.mark.parametrize("how", HOW)
def test_steady_backward_matches_pallas(setup, how):
    jsup, tsup, ysmall, alpha1 = setup
    ysm = torch.as_tensor(ysmall)[:, 1:]
    aT, rest = tnr.steady_forward_plain(
        torch.as_tensor(alpha1), tsup.in_src_r, tsup.pdf_local_r, tsup.in_logw_r, ysm
    )
    # alphas of the source frames 1..T-1: alpha1 and all but the last of rest
    alphas = torch.cat([torch.as_tensor(alpha1)[None], rest[:-1]])
    log_p = torch.logsumexp(aT + tsup.final_logw, dim=-1)
    assert torch.isneginf(log_p[BAD]) and torch.isfinite(log_p).sum() == len(log_p) - 1
    beta1_j, gsm_j = jnr.steady_backward(
        jsup.in_src_r, jsup.pdf_local_r, jsup.in_logw_r, jnp.asarray(ysmall[:, 1:]),
        jnp.asarray(alphas.numpy()), jsup.final_logw, jnp.asarray(log_p.numpy()),
        interpret=True,
        pre=(jsup.src_k, jsup.pdf_local_k, jsup.logw_k) if how == "wrapper_pre" else None,
    )
    n = tnr.steady_backward.launches
    beta1_t, gsm_t = _torch_backward(how, tsup, ysm, alphas, log_p)
    assert gsm_t.shape == (ysmall.shape[1] - 1, ysmall.shape[0], ysmall.shape[2])
    _same_where_finite(beta1_t, beta1_j)
    np.testing.assert_allclose(gsm_t.numpy(), np.asarray(gsm_j), atol=1e-5)
    assert (gsm_t[:, BAD] == 0).all() and (np.asarray(gsm_j)[:, BAD] == 0).all()
    ok = torch.isfinite(log_p)
    # valid sequences: every steady frame's occupancies sum to one
    np.testing.assert_allclose(gsm_t[:, ok].sum(-1).numpy(), 1.0, atol=1e-5)
    assert tnr.steady_backward.launches == n


def test_kernel_tables_hold_the_same_values_in_the_kernels_types(setup):
    _, tsup, _, _ = setup
    bare = dataclasses.replace(tsup, src_k=None, pdf_local_k=None, logw_k=None)
    assert bare.kernel_pre is None
    src_k, lpdf_k, logw_k = tsup.kernel_pre
    for k, ref, dtype in ((src_k, tsup.in_src_r, torch.int32),
                          (lpdf_k, tsup.pdf_local_r, torch.int32),
                          (logw_k, tsup.in_logw_r, torch.float32)):
        assert k.dtype == dtype and k.is_contiguous() and k.shape == ref.shape
        assert torch.equal(k.to(ref.dtype), ref)
    # the int64 tables of the plain path stay
    assert tsup.in_src_r.dtype == torch.int64 and tsup.pdf_local_r.dtype == torch.int64


def test_no_steady_frames_is_the_identity(setup):
    """T = 1: no steady frame, so alpha and beta pass through unchanged."""
    _, tsup, ysmall, alpha1 = setup
    B, _, W = ysmall.shape
    S = tsup.max_states
    none = (tsup.in_src_r[:, :0], tsup.pdf_local_r[:, :0], tsup.in_logw_r[:, :0])
    ysm = torch.as_tensor(ysmall)[:, 1:1]
    a1 = torch.as_tensor(alpha1)
    aT, rest = tnr.steady_forward(a1, *none, ysm)
    assert torch.equal(aT, a1) and rest.shape == (0, B, S)
    beta1, gsm = tnr.steady_backward(*none, ysm, rest, tsup.final_logw, torch.zeros(B))
    assert torch.equal(beta1, tsup.final_logw) and gsm.shape == (0, B, W)


def test_non_finite_log_p_of_any_kind_zeroes_the_occupancies(setup):
    """A NaN log_p (a numeric failure upstream) is contained like -inf."""
    _, tsup, ysmall, alpha1 = setup
    ysm = torch.as_tensor(ysmall)[:, 1:]
    aT, rest = tnr.steady_forward(
        torch.as_tensor(alpha1), tsup.in_src_r, tsup.pdf_local_r, tsup.in_logw_r, ysm
    )
    alphas = torch.cat([torch.as_tensor(alpha1)[None], rest[:-1]])
    log_p = torch.logsumexp(aT + tsup.final_logw, dim=-1)
    log_p[0] = float("nan")
    _, gsm = tnr.steady_backward(
        tsup.in_src_r, tsup.pdf_local_r, tsup.in_logw_r, ysm, alphas, tsup.final_logw, log_p
    )
    assert (gsm[:, 0] == 0).all() and (gsm[:, BAD] == 0).all()
    assert torch.isfinite(gsm).all() and (gsm[:, 2].sum(-1) > 0.99).all()
