"""Numerator of the PyTorch port (ops/num_scan.py): the plain versions of
kernels K5 (vocabulary gather) and K6 (vocabulary scatter) against the JAX
package's Pallas kernels in interpret mode, and the numerator forward-
backward against both configurations of the JAX package, the XLA scan
(TORCHAIN_NUM_RESIDENT=0) and the resident Pallas kernels in interpret mode
(TORCHAIN_NUM_RESIDENT=force), on the same supervision batch and log-probs.
The port has one path, and it must agree with both."""

import dataclasses

import types

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp
import torch

import chip_smoke
import torchain_tpu.data as jdata
import torchain_tpu.graphs as jgraphs
import torchain_tpu_torch.data as tdata
import torchain_tpu_torch.graphs as tgraphs
from torchain_tpu.ops import num_scan as jns
from torchain_tpu.ops.device_graphs import DeviceSupervision as JSup
from torchain_tpu_torch.ops import num_scan as tns
from torchain_tpu_torch.ops.device_graphs import DeviceSupervision as TSup

CORPUS = dict(num_utts=6, num_phones=4, feat_dim=8, utt_frames_out=(8, 11), seed=5)


def _batch(pkg_data, pkg_graphs, B=4, T=8):
    c = pkg_data.synthetic_dataset(**CORPUS)
    ds = pkg_data.ChainDataset(
        c.utts, c.tree, c.norm_fst, chunk_frames_out=T, left_context=2,
        right_context=2,
        sup_opts=pkg_graphs.SupervisionOptions(left_tolerance=2, right_tolerance=2),
    )
    return next(ds.batches(B, shuffle=False)).sup, c.tree.num_pdfs


@pytest.fixture(scope="module")
def setup():
    jb, P = _batch(jdata, jgraphs)
    tb, _ = _batch(tdata, tgraphs)
    # sequence 1 is made impossible: no final state, so log p = -inf
    for b in (jb, tb):
        b.final_logw = b.final_logw.copy()
        b.final_logw[1] = -np.inf
    jsup = JSup.from_host(jb)
    tsup = TSup.from_host(tb, device="cpu")
    B, T = tsup.frame_vocab.shape[:2]
    y = np.random.default_rng(7).normal(size=(B, T, P)).astype(np.float32)
    return jsup, tsup, y, P


def test_vocab_gather_matches_pallas(setup, monkeypatch):
    jsup, tsup, y, _ = setup
    monkeypatch.setenv("TORCHAIN_NUM_PALLAS", "force")
    ref = np.asarray(jns._gather_vocab(jnp.asarray(y), jsup))
    got = tns.vocab_gather(torch.as_tensor(y), tsup.frame_vocab)
    np.testing.assert_array_equal(got.numpy(), ref)  # a copy: exact


def test_vocab_scatter_matches_pallas(setup):
    jsup, tsup, y, P = setup
    vocab = tsup.frame_vocab
    T, B, W = vocab.shape[1], vocab.shape[0], vocab.shape[2]
    valid = torch.ones_like(vocab, dtype=torch.bool)
    valid[..., 1:] = vocab[..., 1:] > vocab[..., :-1]
    rng = np.random.default_rng(8)
    gsm = torch.where(valid.transpose(0, 1),
                      torch.as_tensor(rng.random(size=(T, B, W)), dtype=torch.float32), 0.0)
    ref = np.asarray(jns._scatter_vocab(jnp.asarray(gsm.numpy()), jsup, P))
    got = tns.vocab_scatter(gsm, vocab, P)
    np.testing.assert_array_equal(got.numpy(), ref)  # one non-zero per sum: exact


EDGE_CASES = pytest.mark.parametrize(
    "B,T,W,P", [(4, 8, 16, 83), (3, 2, 16, 1680)], ids=["odd_P", "production_P"])


def _edge_case(B, T, W, P):
    """chip_smoke.py's vocabulary case: rows whose run starts at pdf 0 (beside
    pads of pdf 0), rows that end at pdf P-1, and row (0, 0) of pads alone;
    with occupancies 0.0 on the pads and y of a seeded normal."""
    rng = np.random.default_rng(P)
    vocab, gsm = chip_smoke.vocab_case(rng, B, T, W, P, "cpu")
    assert (vocab[1::3, :, 0] == 0).all() and (vocab[2::3] == P - 1).any(-1).all()
    assert (vocab[0, 0] == 0).all() and (gsm[0, 0] == 0).all()
    y = rng.normal(size=(B, T, P)).astype(np.float32)
    return vocab, gsm, y, types.SimpleNamespace(frame_vocab=jnp.asarray(vocab.numpy()))


@EDGE_CASES
def test_vocab_gather_matches_pallas_at_the_edges(monkeypatch, B, T, W, P):
    vocab, _, y, jsup = _edge_case(B, T, W, P)
    monkeypatch.setenv("TORCHAIN_NUM_PALLAS", "force")
    ref = np.asarray(jns._gather_vocab(jnp.asarray(y), jsup))
    got = tns.vocab_gather(torch.as_tensor(y), vocab)
    np.testing.assert_array_equal(got.numpy(), ref)  # a copy: exact
    assert (got[:, :, -1] == torch.as_tensor(y)[..., 0]).any()  # pads gather pdf 0


@EDGE_CASES
def test_vocab_scatter_matches_pallas_at_the_edges(B, T, W, P):
    vocab, gsm, _, jsup = _edge_case(B, T, W, P)
    ref = np.asarray(jns._scatter_vocab(jnp.asarray(gsm.numpy()), jsup, P))
    got = tns.vocab_scatter(gsm, vocab, P)
    np.testing.assert_array_equal(got.numpy(), ref)  # one non-zero per sum: exact
    assert (got[0, 0] == 0).all() and (got[1::3, :, 0] > 0).all()
    assert (got[2::3, :, P - 1] > 0).all()


def test_vocab_scatter_keeps_real_pdf0_beside_pads():
    """The K6 trap: pad slots repeat pdf 0 and carry 0.0; a real pdf-0
    occupancy in the same row must survive them."""
    vocab = torch.tensor([[[0, 2, 5, 0, 0, 0, 0, 0], [1, 3, 0, 0, 0, 0, 0, 0]]],
                         dtype=torch.int32)  # [B=1, T=2, W=8]
    gsm = torch.zeros(2, 1, 8)
    gsm[0, 0, :3] = torch.tensor([0.25, 0.5, 0.125])
    gsm[1, 0, :2] = torch.tensor([0.75, 0.0625])
    got = tns.vocab_scatter(gsm, vocab, 6)
    ref = np.asarray(jns._scatter_vocab(
        jnp.asarray(gsm.numpy()), types.SimpleNamespace(frame_vocab=jnp.asarray(vocab.numpy())), 6))
    np.testing.assert_array_equal(got.numpy(), ref)
    assert got[0, 0, 0] == 0.25 and got[0, 0, 2] == 0.5 and got[0, 1, 0] == 0.0


def test_numerator_matches_jax_scan(setup, monkeypatch):
    """log p within 1e-5 relative, occupancies within atol 1e-5: float32
    log-sum-exps of a few terms per state, reduced in another order.  The
    impossible sequence has log p = -inf on both sides and exactly zero
    occupancies."""
    jsup, tsup, y, _ = setup
    monkeypatch.setenv("TORCHAIN_NUM_RESIDENT", "0")
    yj = jnp.asarray(y)
    lp_j, al_j = jns.num_forward(yj, jsup)
    g_j = np.asarray(jns.num_backward(yj, jsup, lp_j, al_j))
    yt = torch.as_tensor(y)
    lp_t, al_t = tns.num_forward(yt, tsup)
    g_t = tns.num_backward(yt, tsup, lp_t, al_t).numpy()
    lp_j, lp_t = np.asarray(lp_j), lp_t.numpy()
    assert np.isneginf(lp_j[1]) and np.isneginf(lp_t[1])
    ok = np.isfinite(lp_j)
    assert ok.sum() == len(ok) - 1
    np.testing.assert_allclose(lp_t[ok], lp_j[ok], rtol=1e-5)
    np.testing.assert_allclose(np.asarray(al_t), np.asarray(al_j), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(g_t, g_j, atol=1e-5)
    assert (g_t[1] == 0).all()
    # valid sequences: every frame's occupancies sum to one
    np.testing.assert_allclose(g_t[ok].sum(-1), 1.0, atol=1e-5)
    # pdf 0 is a real vocabulary entry somewhere in this batch, and its
    # occupancy survived the scatter
    assert (g_t[ok][..., 0] > 0).any()


@pytest.mark.parametrize("placed", [False, True], ids=["live_tables", "placed_tables"])
def test_numerator_matches_jax_resident(setup, monkeypatch, placed):
    """The same comparison against the JAX package's resident kernels
    (Pallas, interpret mode), with and without tables prepared at batch
    placement on either side; same tolerances as against the scan."""
    jsup, tsup, y, _ = setup
    if placed:
        jsup, tsup = jsup.with_kernel_tables(), tsup.with_kernel_tables()
        assert tsup.kernel_pre is not None
    monkeypatch.setenv("TORCHAIN_NUM_RESIDENT", "force")
    yj = jnp.asarray(y)
    lp_j, al_j = jns.num_forward(yj, jsup)
    g_j = np.asarray(jns.num_backward(yj, jsup, lp_j, al_j))
    yt = torch.as_tensor(y)
    lp_t, al_t = tns.num_forward(yt, tsup)
    g_t = tns.num_backward(yt, tsup, lp_t, al_t).numpy()
    lp_j, lp_t = np.asarray(lp_j), lp_t.numpy()
    assert np.isneginf(lp_j[1]) and np.isneginf(lp_t[1])
    ok = np.isfinite(lp_j)
    np.testing.assert_allclose(lp_t[ok], lp_j[ok], rtol=1e-5)
    assert al_t.shape == al_j.shape == (y.shape[1] + 1, y.shape[0], tsup.max_states)
    np.testing.assert_allclose(np.asarray(al_t), np.asarray(al_j), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(g_t, g_j, atol=1e-5)
    assert (g_t[1] == 0).all()


@pytest.mark.parametrize("resident", ["0", "force"])
def test_numerator_single_frame(setup, monkeypatch, resident):
    """T = 1 has no steady frames: only the wide frame-0 step runs."""
    jsup, tsup, y, _ = setup
    monkeypatch.setenv("TORCHAIN_NUM_RESIDENT", resident)

    def cut(sup):
        return dataclasses.replace(
            sup, in_src_r=sup.in_src_r[:, :0], in_logw_r=sup.in_logw_r[:, :0],
            pdf_local_r=sup.pdf_local_r[:, :0], frame_vocab=sup.frame_vocab[:, :1],
            num_frames=1,
        )

    jsup1, tsup1 = cut(jsup), cut(tsup)
    assert tsup1.with_kernel_tables().kernel_pre is None
    n3 = tns.num_resident.steady_forward.launches
    yj, yt = jnp.asarray(y[:, :1]), torch.as_tensor(y[:, :1])
    lp_j, al_j = jns.num_forward(yj, jsup1)
    g_j = np.asarray(jns.num_backward(yj, jsup1, lp_j, al_j))
    lp_t, al_t = tns.num_forward(yt, tsup1)
    g_t = tns.num_backward(yt, tsup1, lp_t, al_t).numpy()
    assert al_t.shape == al_j.shape == (2, y.shape[0], tsup.max_states)
    np.testing.assert_allclose(np.asarray(al_t), np.asarray(al_j), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(np.isfinite(lp_t.numpy()), np.isfinite(np.asarray(lp_j)))
    np.testing.assert_allclose(g_t, g_j, atol=1e-5)
    assert g_t.shape == (y.shape[0], 1, y.shape[2])
    assert tns.num_resident.steady_forward.launches == n3
