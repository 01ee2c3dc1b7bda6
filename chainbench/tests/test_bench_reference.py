"""The reference's chain loss against the program's on the CPU (its plain
PyTorch paths), value and gradient, and the precision of its control."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from chainbench import program
from chainbench.corpus import make_corpus
from chainbench.reference.chain import DenGraph, NumGraph, chain_loss, initial_probs
from chainbench.reference.lattice import chunk_lattice, live_sizes, product
from chainbench.reference.ops import Products
from torchain_tpu_torch.ops import ChainLossOptions, DeviceSupervision
from torchain_tpu_torch.ops import chain_loss as port_chain_loss


@pytest.mark.parametrize("seed", [1, 2**31 + 9])
def test_the_chain_loss_is_the_programs(tiny, seed):
    cell = tiny("tdnnf")
    tr, opts = cell.traffic, cell.config["loss"]
    T = tr["chunk_frames_out"]
    corpus = make_corpus(seed, cell.config["corpus"], T, 8)
    graph, norm, tree = program.host_graphs(corpus)
    ds = program.chain_dataset(corpus, norm, tree, tr, (0, 0))
    batch = next(ds.batches(8, shuffle=False, sup_caps=ds.estimate_sup_caps()))
    sup = DeviceSupervision.from_host(batch.sup, device="cpu").with_kernel_tables()
    den = program.auto_den_graph(graph, device="cpu")
    g = torch.Generator().manual_seed(seed % 1000)
    y0 = torch.randn(8, T, corpus.tree.num_pdfs, generator=g)
    x0 = torch.randn(8, T, corpus.tree.num_pdfs, generator=g)

    y, x = y0.clone().requires_grad_(), x0.clone().requires_grad_()
    loss, _ = port_chain_loss(y, x, den, sup, ChainLossOptions(**opts))
    loss.backward()

    d = corpus.den
    rden = DenGraph(d.num_states, d.src, d.dst, d.label, d.logw,
                    initial_probs(d.num_states, d.src, d.dst, d.logw), "cpu")
    lats = [chunk_lattice(c.ali, corpus.tree.pdf, c.left, *tr["tolerance"])
            for c in corpus.chunks[:8]]
    num = NumGraph(product(lats, d.src, d.dst, d.label), rden, "cpu")
    ry, rx = y0.clone().requires_grad_(), x0.clone().requires_grad_()
    rloss = chain_loss(ry, rx, rden, num, opts)
    rloss.backward()
    assert abs(float(rloss) - float(loss)) <= 1e-5 * abs(float(loss))
    torch.testing.assert_close(ry.grad, y.grad, atol=1e-7, rtol=1e-4)
    torch.testing.assert_close(rx.grad, x.grad, atol=1e-7, rtol=1e-4)
    # the live sizes the numerator's roofline counts are the program's
    sizes = live_sizes(product(lats, d.src, d.dst, d.label), d.num_states)
    assert sizes["arcs_steady"] == int((batch.sup.in_src[:, 1:] >= 0).sum())
    assert sizes["arcs_frame0"] == int((batch.sup.in_src[:, 0] >= 0).sum())


def test_the_control_rounds_its_products_to_float8():
    g = torch.Generator().manual_seed(0)
    a, b = torch.randn(32, 64, generator=g), torch.randn(64, 16, generator=g)
    exact = Products("float32")(a, b)
    low = Products("float8")(a.requires_grad_(), b)
    rel = float((low - exact).norm() / exact.norm())
    assert 1e-3 < rel < 0.1
    low.sum().backward()
    # straight through the rounding of a: the gradient is that of the product
    # with b rounded
    torch.testing.assert_close(a.grad, b.sum(1).expand(32, 64), atol=0.2, rtol=0.05)
    with pytest.raises(ValueError):
        Products("int4")
    assert np.isfinite(rel)
