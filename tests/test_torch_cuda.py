"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  These need an NVIDIA GPU and nvcc (they build the kernels); without
a card they skip.  Run them on the GPU machine with

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest

(`--noconftest`: tests/conftest.py configures JAX, which that machine
lacks.)

Graphs and batches are small; chip_smoke.py repeats the comparison at the
main path's shapes."""

import math

import numpy as np
import pytest
import torch

import torchain_tpu_torch.data as tdata
import torchain_tpu_torch.graphs as tgraphs
from torchain_tpu_torch.ops import DeviceSupervision, auto_den_graph
from torchain_tpu_torch.ops import den_resident as dr
from torchain_tpu_torch.ops import num_resident as nr
from torchain_tpu_torch.ops import num_scan as ns

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run on the GPU only)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def setup(dev):
    c = tdata.synthetic_dataset(num_utts=12, num_phones=6, feat_dim=8,
                                utt_frames_out=(9, 12), seed=1, lm_order=3,
                                lm_extra_states=50, context_width=2)
    ds = tdata.ChainDataset(c.utts, c.tree, c.norm_fst, chunk_frames_out=9,
                            left_context=2, right_context=2,
                            sup_opts=tgraphs.SupervisionOptions())
    batch = next(ds.batches(5, shuffle=False))
    den = auto_den_graph(c.den_graph, pad_to=32, device=dev)
    sup = DeviceSupervision.from_host(batch.sup, device=dev)
    B, T = sup.frame_vocab.shape[:2]
    y = torch.as_tensor(np.random.default_rng(2).normal(size=(B, T, den.num_pdfs)),
                        dtype=torch.float32, device=dev)
    return den, sup, y


@pytest.mark.parametrize("leaky", [0.0, 0.1])
def test_den_kernels_match_plain(setup, leaky):
    den, _, y = setup
    yt = y.transpose(0, 1)
    ymax = yt.max(-1).values.contiguous()
    p = torch.exp(yt - ymax[..., None]).contiguous()
    n = dr.den_forward_kernel.launches
    logc_k, ah_k = dr.den_forward_kernel(p, den.V, den.slot_pdf, den.init, leaky)
    torch.cuda.synchronize()
    assert dr.den_forward_kernel.launches == n + 1
    logc_p, ah_p = dr.den_forward_plain(p, den.V, den.slot_pdf, den.init, leaky)
    # float32 sums in another order: 1e-5 on values of order 1
    torch.testing.assert_close(logc_k, logc_p, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(ah_k, ah_p, atol=1e-6, rtol=1e-4)

    log_z = (logc_p.sum(0) + ymax.sum(0) + (math.log1p(leaky) if leaky else 0.0)).contiguous()
    F = torch.cumsum(logc_p + ymax, 0).contiguous()
    args = (p, ah_p, F, ymax, log_z, den.V, den.slot_pdf, den.pdf_offsets,
            den.pdf_slots, den.init, leaky)
    g_k = dr.den_backward_kernel(*args)
    torch.cuda.synchronize()
    g_p = dr.den_backward_plain(*args)
    torch.testing.assert_close(g_k, g_p, atol=1e-5, rtol=1e-4)
    # the same kernel twice gives the same bits (no atomics)
    assert torch.equal(dr.den_backward_kernel(*args), g_k)


def test_den_kernels_raise_on_wrong_dtype(setup):
    den, _, y = setup
    p = torch.exp(y.transpose(0, 1)).contiguous()
    with pytest.raises(TypeError):
        dr.den_forward_kernel(p.double(), den.V, den.slot_pdf, den.init, 0.1)
    with pytest.raises(TypeError):
        dr.den_forward_kernel(p, den.V.half(), den.slot_pdf, den.init, 0.1)


def test_vocab_kernels_match_plain(setup):
    den, sup, y = setup
    vocab = sup.frame_vocab
    n5, n6 = ns.vocab_gather.launches, ns.vocab_scatter.launches
    assert torch.equal(ns.vocab_gather(y, vocab), ns.vocab_gather_plain(y, vocab))
    valid = torch.ones_like(vocab, dtype=torch.bool)
    valid[..., 1:] = vocab[..., 1:] > vocab[..., :-1]
    gsm = torch.where(valid, torch.rand(vocab.shape, device=y.device), 0.0)
    gsm = gsm.transpose(0, 1).contiguous()
    P = den.num_pdfs
    assert torch.equal(ns.vocab_scatter(gsm, vocab, P), ns.vocab_scatter_plain(gsm, vocab, P))
    torch.cuda.synchronize()
    assert (ns.vocab_gather.launches, ns.vocab_scatter.launches) == (n5 + 1, n6 + 1)


def _steady_case(dev, B, T, S, Kr, W, seed):
    """Random left-packed steady tables with odd sizes; sequence 1 (where
    there is one) has no final state, so its log p is -inf."""
    rng = np.random.default_rng(seed)
    Tm1 = T - 1
    live = rng.integers(0, Kr + 1, size=(B, Tm1, S, 1))  # arcs per row, pads to the right
    pad = np.arange(Kr) >= live
    src = np.where(pad, -1, rng.integers(0, S, size=(B, Tm1, S, Kr)))
    lpdf = np.where(pad, 0, rng.integers(0, W, size=(B, Tm1, S, Kr)))
    logw = np.where(pad, 0.0, rng.normal(size=(B, Tm1, S, Kr))).astype(np.float32)
    t = lambda a, dt: torch.as_tensor(a, dtype=dt, device=dev)  # noqa: E731
    src, lpdf, logw = t(src, torch.int64), t(lpdf, torch.int64), t(logw, torch.float32)
    # a [B, T, W] gather of which the steady frames are a strided slice
    ysmall = t(rng.normal(size=(B, T, W)), torch.float32)
    alpha1 = t(np.where(rng.random(size=(B, S)) < 0.3, -np.inf, rng.normal(size=(B, S))),
               torch.float32)
    final = t(np.where(rng.random(size=(B, S)) < 0.5, -np.inf, 0.0), torch.float32)
    final[:, 0] = 0.0
    if B > 1:
        final[1] = -np.inf
    return alpha1, src, lpdf, logw, ysmall[:, 1:], final


def _close_where_finite(got, want, atol=1e-5, rtol=1e-5):
    fin = torch.isfinite(want)
    assert torch.equal(torch.isfinite(got), fin) and not torch.isnan(got).any()
    torch.testing.assert_close(got[fin], want[fin], atol=atol, rtol=rtol)


@pytest.mark.parametrize("placed", [False, True], ids=["live_tables", "placed_tables"])
@pytest.mark.parametrize(
    "B,T,S,Kr,W", [(5, 9, 7, 3, 8), (3, 2, 5, 1, 8), (2, 12, 70, 5, 40)],
    ids=["odd_sizes", "two_frames", "more_states_than_a_warp"],
)
def test_steady_kernels_match_plain(dev, B, T, S, Kr, W, placed):
    alpha1, src, lpdf, logw, ysm, final = _steady_case(dev, B, T, S, Kr, W, seed=S)
    pre = nr.kernel_tables(src, lpdf, logw) if placed else None
    n3, n4 = nr.steady_forward.launches, nr.steady_backward.launches
    aT_k, rest_k = nr.steady_forward(alpha1, src, lpdf, logw, ysm, pre=pre)
    torch.cuda.synchronize()
    aT_p, rest_p = nr.steady_forward_plain(alpha1, src, lpdf, logw, ysm)
    # float32 log-sum-exps of a few terms, summed in another order
    _close_where_finite(rest_k, rest_p)
    assert torch.equal(aT_k, rest_k[-1])
    # the same kernel twice gives the same bits
    assert torch.equal(nr.steady_forward(alpha1, src, lpdf, logw, ysm, pre=pre)[1], rest_k)

    alphas = torch.cat([alpha1[None], rest_p[:-1]])
    log_p = torch.logsumexp(aT_p + final, dim=-1)
    if B > 1:
        assert torch.isneginf(log_p[1])
    args = (src, lpdf, logw, ysm, alphas, final, log_p)
    beta1_k, gsm_k = nr.steady_backward(*args, pre=pre)
    torch.cuda.synchronize()
    beta1_p, gsm_p = nr.steady_backward_plain(*args)
    _close_where_finite(beta1_k, beta1_p)
    torch.testing.assert_close(gsm_k, gsm_p, atol=1e-6, rtol=1e-5)
    if B > 1:
        assert (gsm_k[:, 1] == 0).all()
    again = nr.steady_backward(*args, pre=pre)
    assert torch.equal(again[0], beta1_k) and torch.equal(again[1], gsm_k)
    torch.cuda.synchronize()
    assert (nr.steady_forward.launches, nr.steady_backward.launches) == (n3 + 2, n4 + 2)


def test_steady_kernels_without_steady_frames_launch_nothing(dev):
    """T = 1: alpha and beta pass through, and no kernel runs."""
    alpha1, src, lpdf, logw, ysm, final = _steady_case(dev, 3, 1, 5, 2, 8, seed=0)
    n3, n4 = nr.steady_forward.launches, nr.steady_backward.launches
    aT, rest = nr.steady_forward(alpha1, src, lpdf, logw, ysm)
    assert torch.equal(aT, alpha1) and rest.shape == (0, 3, 5)
    beta1, gsm = nr.steady_backward(src, lpdf, logw, ysm, rest, final,
                                    torch.zeros(3, device=dev))
    assert torch.equal(beta1, final) and gsm.shape == (0, 3, 8)
    assert (nr.steady_forward.launches, nr.steady_backward.launches) == (n3, n4)


def test_steady_kernels_raise_on_wrong_dtype(dev):
    alpha1, src, lpdf, logw, ysm, final = _steady_case(dev, 3, 4, 5, 2, 8, seed=1)
    with pytest.raises(TypeError):
        nr.steady_forward(alpha1.double(), src, lpdf, logw, ysm)
    with pytest.raises(TypeError):
        nr.steady_forward(alpha1, src, lpdf, logw, ysm.half())
    with pytest.raises(TypeError):  # placed tables must already be int32
        nr.steady_forward(alpha1, src, lpdf, logw, ysm, pre=(src, lpdf, logw))
    alphas = torch.zeros(3, 3, 5, device=dev)
    with pytest.raises(TypeError):
        nr.steady_backward(src, lpdf, logw, ysm, alphas, final,
                           torch.zeros(3, device=dev, dtype=torch.float64))


def test_numerator_on_card_matches_cpu(setup):
    """num_forward / num_backward through K5, K3, K4 and K6 on the card
    against the plain versions on the CPU, with and without placed tables."""
    _, sup, y = setup
    lp_c, al_c = ns.num_forward(y.cpu(), sup.to("cpu"))
    g_c = ns.num_backward(y.cpu(), sup.to("cpu"), lp_c, al_c)
    for s in (sup, sup.with_kernel_tables()):
        n3, n4 = nr.steady_forward.launches, nr.steady_backward.launches
        lp, al = ns.num_forward(y, s)
        g = ns.num_backward(y, s, lp, al)
        torch.cuda.synchronize()
        assert (nr.steady_forward.launches, nr.steady_backward.launches) == (n3 + 1, n4 + 1)
        torch.testing.assert_close(lp.cpu(), lp_c, atol=1e-5, rtol=1e-5)
        _close_where_finite(al.cpu(), al_c)
        torch.testing.assert_close(g.cpu(), g_c, atol=1e-5, rtol=1e-5)


def test_chain_loss_on_card_matches_cpu(setup):
    """The loss and its gradient through all six kernels agree with the
    plain versions on the CPU."""
    from torchain_tpu_torch.ops import ChainLossOptions, chain_loss

    den, sup, y = setup
    opts = ChainLossOptions(l2_regularize=5e-4, leaky_hmm_coefficient=0.1, xent_regularize=0.1)
    out = {}
    for d in ("cuda", "cpu"):
        yy = y.detach().to(d).requires_grad_()
        loss, _ = chain_loss(yy, yy * 0.5, den.to(d), sup.to(d), opts)
        loss.backward()
        out[d] = (loss.detach().cpu(), yy.grad.cpu())
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(out["cuda"][1], out["cpu"][1], rtol=1e-4, atol=1e-6)
