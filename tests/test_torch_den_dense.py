"""The dense Moore denominator of the PyTorch port against the JAX package:
the host factorization (make_dense_den_graph), its device containers, the
matrix-product recursion (ops/den_dense.py), the sparse log-semiring
recursion (ops/den_scan.py), the plain versions of the fused kernels
K9f/K9b (ops/den_pallas.py, which its wrappers run on CPU tensors; the JAX
side runs its Pallas kernels in interpret mode), and the chain loss's
dispatch on the graph's type.

Same graph and numpy log-probs on both sides.  Tolerances: tables equal
exactly; log Z rtol 1e-5 (atol 1e-5 where it lies near 0) and the
occupancies atol 2e-4 (as
tests/test_torch_den.py and tests/test_den_pallas.py: float32 on both
sides, sums in another order, carried through T per-frame
renormalisations), also against the float64 NumPy oracle."""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")

import jax
import jax.numpy as jnp
import torch

import torchain_tpu.graphs as jgraphs
import torchain_tpu.ops as jops
import torchain_tpu_torch.graphs as tgraphs
import torchain_tpu_torch.ops as tops
from torchain_tpu.ops import den_dense as jdd
from torchain_tpu.ops import den_pallas as jdp
from torchain_tpu.ops import den_scan as jds
from torchain_tpu.ops import oracle
from torchain_tpu.ops.device_graphs import DeviceDenGraph as JSparse
from torchain_tpu.ops.device_graphs import DeviceDenseDenGraph as JDense
from torchain_tpu_torch.ops import den_dense as tdd
from torchain_tpu_torch.ops import den_pallas as tdp
from torchain_tpu_torch.ops import den_resident as tdr
from torchain_tpu_torch.ops import den_scan as tds
from torchain_tpu_torch.ops.device_graphs import DeviceDenGraph as TSparse
from torchain_tpu_torch.ops.device_graphs import DeviceDenseDenGraph as TDense

ATOL = 2e-4
#: log Z: a sum of T float32 terms of order 1 each, so a value that happens
#: to lie near 0 is held absolutely
ZTOL = dict(rtol=1e-5, atol=1e-5)
B, T = 3, 7


def _graph(pkg, order=2, phones=3, ctx=1, seed=0, n_sents=30):
    rng = np.random.default_rng(seed)
    sents = [
        list(map(int, rng.integers(1, phones + 1, size=rng.integers(3, 8))))
        for _ in range(n_sents)
    ]
    lm = pkg.estimate_phone_lm(
        sents, pkg.PhoneLmOptions(ngram_order=order, num_extra_lm_states=20)
    )
    tree = pkg.ContextTree(phones, context_width=ctx)
    return pkg.compile_den_graph(pkg.make_den_fst(lm, tree), tree.num_pdfs)


GRAPHS = {
    "bigram": dict(order=2, phones=3, ctx=1, seed=0),
    "trigram_biphone": dict(order=3, phones=4, ctx=2, seed=2),
}
#: pad_to per graph, such that real_exp is not a multiple of the padding
#: and padded expanded states exist
PADS = {"bigram": 8, "trigram_biphone": 12}
PAD = 8


@pytest.fixture(scope="module", params=sorted(GRAPHS))
def graphs(request):
    kw, pad = GRAPHS[request.param], PADS[request.param]
    jhost, thost = _graph(jgraphs, **kw), _graph(tgraphs, **kw)
    jdense = jgraphs.make_dense_den_graph(jhost, pad_to=pad)
    tdense = tgraphs.make_dense_den_graph(thost, pad_to=pad)
    y = np.random.default_rng(1).normal(size=(B, T, thost.num_pdfs)).astype(np.float32)
    return dict(jhost=jhost, thost=thost, jdense=jdense, tdense=tdense, y=y,
                jg=JDense.from_host(jdense), tg=TDense.from_host(tdense, device="cpu"))


def test_dense_graph_equals_jax(graphs):
    jd, td = graphs["jdense"], graphs["tdense"]
    for f in dataclasses.fields(jd):
        np.testing.assert_array_equal(getattr(td, f.name), getattr(jd, f.name), err_msg=f.name)
    # padded expanded states exist, and point at original state 0
    assert td.real_exp < td.num_exp and (td.orig_of_exp[td.real_exp:] == 0).all()
    jg, tg = graphs["jg"], graphs["tg"]
    for name in ("V", "E_mat", "P_mat", "init_orig"):
        np.testing.assert_array_equal(getattr(tg, name).numpy(), np.asarray(getattr(jg, name)),
                                      err_msg=name)
    assert (tg.num_orig, tg.num_exp, tg.num_pdfs) == (jg.num_orig, jg.num_exp, jg.num_pdfs)
    assert tg.fused is False and TDense.from_host(td, device="cpu", fused=True).fused is True


def test_synthetic_corpus_carries_the_dense_form():
    """`synthetic_dataset` builds the dense Moore form of a small graph (at
    the default padding), equal to the JAX package's."""
    import torchain_tpu.data as jdata
    import torchain_tpu_torch.data as tdata

    kw = dict(num_utts=6, num_phones=4, feat_dim=8, utt_frames_out=(9, 12), seed=6,
              lm_order=3, lm_extra_states=30)
    jd, td = jdata.synthetic_dataset(**kw).dense_den, tdata.synthetic_dataset(**kw).dense_den
    assert td.num_orig % 128 == 0 and td.num_exp % 128 == 0
    for f in dataclasses.fields(jd):
        np.testing.assert_array_equal(getattr(td, f.name), getattr(jd, f.name), err_msg=f.name)


def test_dense_graph_index_tables_agree_with_e_mat(graphs):
    """What the fused kernels index equals what den_dense multiplies: the
    list of each original state's real expanded states is E_mat's columns,
    and the padded expanded states are in no list."""
    tg = graphs["tg"]
    E_mat = tg.E_mat.numpy()
    off, exps = tg.orig_offsets.numpy(), tg.orig_exps.numpy()
    assert tg.orig_of_exp.dtype == tg.pdf_of_exp.dtype == torch.int32
    assert off[0] == 0 and off[-1] == tg.real_exp == len(exps)
    for s in range(tg.num_orig):
        np.testing.assert_array_equal(exps[off[s]:off[s + 1]], np.flatnonzero(E_mat[:, s]))
    assert E_mat[tg.real_exp:].sum() == 0
    x = torch.as_tensor(np.random.default_rng(0).random((2, tg.num_exp)).astype(np.float32))
    seg = x.new_zeros((2, tg.num_orig)).index_add_(
        1, tg.orig_of_exp[: tg.real_exp].long(), x[:, : tg.real_exp])
    np.testing.assert_allclose(seg.numpy(), (x @ tg.E_mat).numpy(), rtol=1e-6)


def test_sparse_graph_equals_jax(graphs):
    jg, tg = JSparse.from_host(graphs["jhost"]), TSparse.from_host(graphs["thost"], device="cpu")
    for name in ("in_src", "in_pdf", "in_logw", "in_dst", "out_src", "out_dst", "out_pdf",
                 "out_logw", "log_init"):
        np.testing.assert_array_equal(getattr(tg, name).numpy(), np.asarray(getattr(jg, name)),
                                      err_msg=name)
    assert (tg.num_states, tg.num_pdfs) == (jg.num_states, jg.num_pdfs)
    assert tg.to("meta").in_src.device.type == "meta"


@pytest.mark.parametrize("leaky", [0.0, 0.1])
def test_den_dense_matches_jax(graphs, leaky):
    y = graphs["y"]
    z_j, res_j = jdd.den_forward(jnp.asarray(y), graphs["jg"], leaky)
    g_j = jdd.den_backward(graphs["jg"], res_j, leaky)
    z_t, res_t = tdd.den_forward(torch.as_tensor(y), graphs["tg"], leaky)
    g_t = tdd.den_backward(graphs["tg"], res_t, leaky)
    assert set(res_t) == set(res_j)
    np.testing.assert_allclose(z_t.numpy(), np.asarray(z_j), **ZTOL)
    np.testing.assert_allclose(res_t["sigma_hats"].numpy(), np.asarray(res_j["sigma_hats"]),
                               atol=ATOL)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), atol=ATOL)
    np.testing.assert_allclose(g_t.sum(-1).numpy(), 1.0, atol=ATOL)


@pytest.mark.parametrize("leaky", [0.0, 0.1])
def test_den_scan_matches_jax(graphs, leaky):
    y = graphs["y"]
    jg, tg = JSparse.from_host(graphs["jhost"]), TSparse.from_host(graphs["thost"], device="cpu")
    z_j, al_j = jds.den_forward(jnp.asarray(y), jg, leaky)
    g_j = jds.den_backward(jnp.asarray(y), jg, z_j, al_j, leaky)
    z_t, al_t = tds.den_forward(torch.as_tensor(y), tg, leaky)
    g_t = tds.den_backward(torch.as_tensor(y), tg, z_t, al_t, leaky)
    np.testing.assert_allclose(z_t.numpy(), np.asarray(z_j), **ZTOL)
    fin = np.isfinite(np.asarray(al_j))
    np.testing.assert_array_equal(np.isfinite(al_t.numpy()), fin)
    np.testing.assert_allclose(al_t.numpy()[fin], np.asarray(al_j)[fin], atol=ATOL)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), atol=ATOL)


def test_seg_logsumexp_handles_empty_and_dead_segments():
    vals = torch.tensor([[0.0, -np.inf], [1.0, -np.inf], [-np.inf, 2.0]])
    out = tds._seg_logsumexp(vals, torch.tensor([0, 0, 2]), 4)
    want = np.array([[np.log(np.e + 1), -np.inf], [-np.inf, -np.inf], [-np.inf, 2.0],
                     [-np.inf, -np.inf]], np.float32)
    assert not torch.isnan(out).any()
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-6)


@pytest.mark.parametrize("leaky", [0.0, 0.1])
def test_k9_plain_versions_match_pallas_interpret(graphs, leaky):
    """ops/den_pallas.py on CPU tensors (the K9 plain versions, which index
    with orig_of_exp) against the JAX package's fused Pallas kernels in
    interpret mode (which multiply E_mat), residual by residual, on a graph
    with padded expanded states; the kernel-level twins also directly on
    the JAX side's pe."""
    y = graphs["y"]
    z_j, res_j = jdp.den_forward(jnp.asarray(y), graphs["jg"], leaky, interpret=True)
    g_j = jdp.den_backward(graphs["jg"], res_j, leaky, interpret=True)
    n = (tdp.dense_forward_kernel.launches, tdp.dense_backward_kernel.launches)
    z_t, res_t = tdp.den_forward(torch.as_tensor(y), graphs["tg"], leaky)
    g_t = tdp.den_backward(graphs["tg"], res_t, leaky)
    assert set(res_t) == set(res_j) and "pe" in res_t
    np.testing.assert_allclose(z_t.numpy(), np.asarray(z_j), **ZTOL)
    for name in ("p", "pe", "ymax", "logc", "sigma_hats"):
        np.testing.assert_allclose(res_t[name].numpy(), np.asarray(res_j[name]), atol=ATOL,
                                   err_msg=name)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), atol=ATOL)
    # each frame's occupancies sum to one, over pdfs and over expanded states
    np.testing.assert_allclose(g_t.sum(-1).numpy(), 1.0, atol=ATOL)
    pe = torch.as_tensor(np.asarray(res_j["pe"]))
    logc, sig = tdp.dense_forward_kernel(pe, graphs["tg"], leaky)
    np.testing.assert_allclose(logc.numpy(), np.asarray(res_j["logc"]), atol=ATOL)
    ymax_t = torch.as_tensor(np.asarray(res_j["ymax"]).T.copy())
    F = torch.cumsum(logc + ymax_t, 0)
    fscale = torch.cat([F.new_zeros((1, B)), F[:-1]]) + ymax_t - torch.as_tensor(np.asarray(z_j))
    gout = tdp.dense_backward_kernel(pe, graphs["tg"], sig, fscale, ymax_t, leaky)
    np.testing.assert_allclose(gout.sum(-1).numpy(), 1.0, atol=ATOL)
    assert (gout[..., graphs["tg"].real_exp:] == 0).all()
    # CPU tensors: the plain versions ran, nothing was launched
    assert (tdp.dense_forward_kernel.launches, tdp.dense_backward_kernel.launches) == n


def test_padded_expanded_states_are_left_out_of_the_backward(graphs):
    """The trap: orig_of_exp points the padded expanded states at state 0.
    Were they read like real ones, d = max(nb) and with it G would see
    v[0] once more while gamma still looked plausible.  With state 0 made
    the likeliest predecessor, the plain K9b still agrees with den_dense
    (which multiplies E_mat and so never sees them)."""
    tg = graphs["tg"]
    rng = np.random.default_rng(7)
    y = rng.normal(size=(B, T, tg.num_pdfs)).astype(np.float32)
    boosted = dataclasses.replace(tg, V=tg.V.clone())
    boosted.V[0] *= 50.0  # v[0] = (pe * bh) @ V[0] becomes the row maximum
    z_d, res_d = tdd.den_forward(torch.as_tensor(y), boosted, 0.1)
    g_d = tdd.den_backward(boosted, res_d, 0.1)
    z_p, res_p = tdp.den_forward(torch.as_tensor(y), boosted, 0.1)
    g_p = tdp.den_backward(boosted, res_p, 0.1)
    np.testing.assert_allclose(z_p.numpy(), z_d.numpy(), **ZTOL)
    np.testing.assert_allclose(g_p.numpy(), g_d.numpy(), atol=ATOL)


@pytest.mark.parametrize("leaky", [0.0, 0.1])
def test_all_denominator_forms_agree_and_match_the_oracle(graphs, leaky):
    """Within the port: resident, dense (both forms) and scan on one graph,
    each against the float64 NumPy oracle."""
    y, thost = graphs["y"], graphs["thost"]
    yt = torch.as_tensor(y)
    results = {}
    res_g = tdr.DeviceResidentDenGraph.from_host(thost, pad_to=PAD, device="cpu")
    z, res = tdr.den_forward(yt, res_g, leaky)
    results["resident"] = (z, tdr.den_backward(res_g, res, leaky))
    z, res = tdd.den_forward(yt, graphs["tg"], leaky)
    results["dense"] = (z, tdd.den_backward(graphs["tg"], res, leaky))
    z, res = tdp.den_forward(yt, graphs["tg"], leaky)
    results["fused"] = (z, tdp.den_backward(graphs["tg"], res, leaky))
    sp = TSparse.from_host(thost, device="cpu")
    z, al = tds.den_forward(yt, sp, leaky)
    results["scan"] = (z, tds.den_backward(yt, sp, z, al, leaky))
    for name, (z, g) in results.items():
        for b in range(B):
            z_ref, g_ref = oracle.den_forward_backward(graphs["jhost"], y[b], leaky)
            np.testing.assert_allclose(z[b].numpy(), z_ref, err_msg=name, **ZTOL)
            np.testing.assert_allclose(g[b].numpy(), g_ref, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("form", ["resident", "dense", "fused", "scan"])
def test_chain_loss_dispatches_on_the_graph_type(graphs, form):
    """The loss and its gradients with each denominator form against the
    JAX package's chain_loss with its counterpart (the fused form against
    den_dense: off the accelerator the JAX package never picks its Pallas
    kernels)."""
    import torchain_tpu.data as jdata
    import torchain_tpu_torch.data as tdata
    from torchain_tpu.ops.den_resident import DeviceResidentDenGraph as JResident

    corpus = dict(num_utts=6, num_phones=4, feat_dim=8, utt_frames_out=(9, 12), seed=6,
                  lm_order=3, lm_extra_states=30)
    sides = []
    for pkg_data, pkg_graphs in ((jdata, jgraphs), (tdata, tgraphs)):
        c = pkg_data.synthetic_dataset(**corpus)
        ds = pkg_data.ChainDataset(
            c.utts, c.tree, c.norm_fst, chunk_frames_out=9, left_context=2, right_context=2,
            sup_opts=pkg_graphs.SupervisionOptions(left_tolerance=2, right_tolerance=2))
        sides.append((c, next(ds.batches(3, shuffle=False)).sup))
    (jc, jb), (tc, tb) = sides
    jdense = jgraphs.make_dense_den_graph(jc.den_graph, pad_to=PAD)
    tdense = tgraphs.make_dense_den_graph(tc.den_graph, pad_to=PAD)
    jden, tden = dict(
        resident=lambda: (JResident.from_host(jc.den_graph, pad_to=PAD, dtype=jnp.float32),
                          tops.auto_den_graph(tc.den_graph, pad_to=PAD, device="cpu")),
        dense=lambda: (JDense.from_host(jdense), TDense.from_host(tdense, device="cpu")),
        fused=lambda: (JDense.from_host(jdense),
                       TDense.from_host(tdense, device="cpu", fused=True)),
        scan=lambda: (JSparse.from_host(jc.den_graph),
                      TSparse.from_host(tc.den_graph, device="cpu")),
    )[form]()
    jsup = jops.DeviceSupervision.from_host(jb)
    tsup = tops.DeviceSupervision.from_host(tb, device="cpu")
    rng = np.random.default_rng(3)
    y = rng.normal(size=(3, 9, jc.tree.num_pdfs)).astype(np.float32)
    x = rng.normal(size=y.shape).astype(np.float32)
    opts = dict(l2_regularize=5e-4, leaky_hmm_coefficient=0.1, xent_regularize=0.1)

    def jloss(y, x):
        return jops.chain_loss(y, x, jden, jsup, jops.ChainLossOptions(**opts))

    (l_j, aux_j), (dy_j, dx_j) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(y), jnp.asarray(x))
    yt = torch.tensor(y, requires_grad=True)
    xt = torch.tensor(x, requires_grad=True)
    counts = (tdp.dense_forward_kernel.launches, tdr.den_forward_kernel.launches)
    l_t, aux_t = tops.chain_loss(yt, xt, tden, tsup, tops.ChainLossOptions(**opts))
    l_t.backward()
    assert (tdp.dense_forward_kernel.launches, tdr.den_forward_kernel.launches) == counts
    np.testing.assert_allclose(float(l_t.detach()), float(l_j), rtol=1e-5)
    for k in aux_j:
        np.testing.assert_allclose(float(aux_t[k].detach()), float(aux_j[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    np.testing.assert_allclose(yt.grad.numpy(), np.asarray(dy_j), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx_j), rtol=1e-4, atol=1e-6)


def test_chain_loss_refuses_an_unknown_graph(graphs):
    from torchain_tpu_torch.ops.chain_loss import _den_forward

    y = torch.zeros(1, 2, graphs["tg"].num_pdfs)
    with pytest.raises(TypeError, match="no denominator recursion"):
        _den_forward(y, object(), 0.1)
