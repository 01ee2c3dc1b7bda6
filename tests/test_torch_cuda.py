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


def test_chain_loss_on_card_matches_cpu(setup):
    """The loss and its gradient through all four kernels agree with the
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
