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
import math

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
from test_torch_den import _expand, _fma, _shares, _tree, _u16, _walk
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


# ---------------------------------------------------------------------------
# K9f/K9b: V's compressed forms, and the kernels' order of summation
# ---------------------------------------------------------------------------


def test_moore_compressed_forms_rebuild_V_exactly(graphs):
    """The CSC (by expanded state) and the CSR (by original state) of the
    Moore V expand to exactly V, their indices and orig16 are 16-bit and
    unsigned, and no entry lies in a padded expanded state's column."""
    tg = graphs["tg"]
    V = tg.V.numpy()
    assert tg.csc_rows.dtype == tg.csr_cols.dtype == tg.orig16.dtype == torch.int16
    assert tg.nnz == int(np.count_nonzero(V)) == tg.csr_vals.shape[0]
    np.testing.assert_array_equal(
        _expand(tg.csc_offsets, tg.csc_rows, tg.csc_vals, V.shape, by_col=True), V)
    np.testing.assert_array_equal(
        _expand(tg.csr_offsets, tg.csr_cols, tg.csr_vals, V.shape, by_col=False), V)
    np.testing.assert_array_equal(_u16(tg.orig16).numpy(), tg.orig_of_exp.numpy())
    assert (np.diff(tg.csc_offsets.numpy())[tg.real_exp:] == 0).all()


def test_k9_refuses_indices_beyond_16_bits():
    """A Moore graph with E = 65,536 keeps int32 indices for the plain
    versions, and the kernels' plan refuses it before asking the library."""
    from torchain_tpu_torch.graphs import DenseDenGraph

    S, E = 8, 65536
    V = np.zeros((S, E), np.float32)
    V[np.arange(E) % S, np.arange(E)] = 0.5
    orig = (np.arange(E) % S).astype(np.int32)
    host = DenseDenGraph(num_pdfs=3, num_orig=S, num_exp=E, real_orig=S, real_exp=E, V=V,
                         orig_of_exp=orig, pdf_of_exp=orig % 3,
                         init_exp=np.zeros(E, np.float32),
                         initial_probs=np.full(S, 1.0 / S, np.float32))
    g = TDense.from_host(host, device="cpu", fused=True)
    assert g.csc_rows.dtype == g.csr_cols.dtype == g.orig16.dtype == torch.int32
    for backward in (0, 1):
        with pytest.raises(ValueError, match="16 bits"):
            tdp.shared_plan(g, backward, torch.device("cpu"))


def emulate_dense_forward(pe, g, leaky, N=tdr.THREADS):
    """K9f as csrc/den_dense.cu computes it: h by the CSC, the block sums
    by per-thread shares and butterflies, each state's carry over its list
    of real expanded states in list order."""
    T, B, E = pe.shape
    S, init = g.num_orig, g.init_orig
    off, exps = g.orig_offsets.long(), g.orig_exps.long()
    cnt = off[1:] - off[:-1]

    def leak(sh):
        if leaky <= 0.0:
            return sh
        return _fma((leaky * _tree(_shares(sh, N)))[:, None], init, sh)

    sh = init.expand(B, S).clone()
    logc, sig = pe.new_empty((T, B)), pe.new_empty((T, B, S))
    for t in range(T):
        sig[t] = sh
        a = _walk(g.csc_offsets, g.csc_rows, g.csc_vals, leak(sh)) * pe[t]
        c = _tree(_shares(a, N))
        logc[t] = torch.log(c)
        sh = pe.new_zeros((B, S))
        for r in range(int(cnt.max())):
            e = exps[(off[:-1] + r).clamp(max=exps.shape[0] - 1)]
            sh = torch.where(cnt > r, sh + a[:, e] / c[:, None], sh)
    return logc, sig


def emulate_dense_backward(pe, g, sig, fscale, ymax_t, leaky, N=tdr.THREADS, ds=None):
    """K9b as csrc/den_dense.cu computes it: bh carried over the original
    states, h by the CSC, v by the CSR, d the maximum over the states that
    a real expanded state enters (and 0 where padded ones exist).  Each
    frame's d is appended to `ds`, where given."""
    T, B, E = pe.shape
    init = g.init_orig
    orig = _u16(g.orig16)
    real = torch.arange(E) < g.real_exp
    entered = g.orig_offsets[1:] > g.orig_offsets[:-1]
    bh = None  # the first frame's is 1 on every expanded state
    G = pe.new_full((B,), math.log1p(leaky) if leaky > 0.0 else 0.0)
    gout = pe.new_empty((T, B, E))
    for t in range(T - 1, -1, -1):
        sigma = sig[t]
        if leaky > 0.0:
            sigma = _fma((leaky * _tree(_shares(sigma, N)))[:, None], init, sigma)
        h = _walk(g.csc_offsets, g.csc_rows, g.csc_vals, sigma)
        be = torch.ones_like(h) if bh is None else torch.where(real, bh[:, orig], 0.0)
        gout[t] = pe[t] * h * be * torch.exp(fscale[t] + G)[:, None]
        if t == 0:
            break
        v = _walk(g.csr_offsets, g.csr_cols, g.csr_vals, pe[t] * be)
        d = torch.where(entered, v, -np.inf).max(-1).values
        if leaky > 0.0:
            add = leaky * _tree(_shares(v, N, init))
            d, v = d + add, v + add[:, None]
        if g.real_exp < E:
            d = torch.maximum(d, torch.zeros(()))
        d = torch.where(d > 0, d, torch.ones_like(d))
        if ds is not None:
            ds.append(d)
        bh = v / d[:, None]
        G = (G + ymax_t[t]) + torch.log(d)
    return gout


#: K9f's and K9b's tolerances against their plain versions, as chip_smoke.py
#: holds the kernels on the card: (atol, rtol)
K9_TOL = dict(logc=(1e-5, 0.0), sigma_hats=(1e-6, 1e-4), gout=(1e-6, 1e-4),
              gamma=(1e-5, 1e-4))


def _k9_close(what, got, want):
    atol, rtol = K9_TOL[what]
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=rtol,
                               err_msg=what)


def _k9_emulated_and_plain(tg, y, leaky):
    """K9f and K9b emulated and plain on the pe of y [B, T, P]: the
    backwards on the plain forward's residuals, and the emulation end to
    end (its own residuals) to gamma [B, T, P]."""
    y = torch.as_tensor(y)
    ymax = y.max(-1).values  # [B, T]
    pe = (torch.exp(y - ymax[..., None]).transpose(0, 1) @ tg.P_mat).contiguous()
    ymax_t = ymax.T.contiguous()
    extra = math.log1p(leaky) if leaky > 0.0 else 0.0

    def fscale(logc):
        F = torch.cumsum(logc + ymax_t, 0)
        log_z = logc.sum(0) + ymax_t.sum(0) + extra
        return torch.cat([F.new_zeros((1, F.shape[1])), F[:-1]]) + ymax_t - log_z

    logc_e, sig_e = emulate_dense_forward(pe, tg, leaky)
    logc_p, sig_p = tdp.dense_forward_plain(pe, tg, leaky)
    args = (pe, tg, sig_p, fscale(logc_p), ymax_t, leaky)
    gout_e = emulate_dense_backward(pe, tg, sig_e, fscale(logc_e), ymax_t, leaky)
    return dict(
        logc=(logc_e, logc_p), sigma_hats=(sig_e, sig_p),
        gout=(emulate_dense_backward(*args), tdp.dense_backward_plain(*args)),
        end_to_end=(logc_e, sig_e, torch.einsum("tbe,pe->btp", gout_e, tg.P_mat)),
    )


@pytest.mark.parametrize("leaky", [0.0, 0.1])
def test_k9_kernel_order_matches_plain_and_jax(graphs, leaky):
    """K9f's and K9b's sums, emulated in the kernels' order over the
    compressed forms, against the plain versions and the JAX package's
    Pallas kernels (interpret mode), within K9's tolerances."""
    out = _k9_emulated_and_plain(graphs["tg"], graphs["y"], leaky)
    for what in ("logc", "sigma_hats", "gout"):
        _k9_close(what, *out[what])
    _, res_j = jdp.den_forward(jnp.asarray(graphs["y"]), graphs["jg"], leaky, interpret=True)
    gamma_j = jdp.den_backward(graphs["jg"], res_j, leaky, interpret=True)
    logc_e, sig_e, gamma_e = out["end_to_end"]
    _k9_close("logc", logc_e, res_j["logc"])
    _k9_close("sigma_hats", sig_e, res_j["sigma_hats"])
    _k9_close("gamma", gamma_e, gamma_j)


@pytest.fixture(scope="module")
def bench_moore():
    """The dense Moore form of chip_smoke.py's trigram graph (S 2176, E 4224,
    12,376 non-zeros), as the `dense` path places it."""
    import chip_smoke

    corpus = chip_smoke._corpus(0, tuple(sorted(chip_smoke.PATHS["dense"]["corpus"].items())))
    return TDense.from_host(corpus.dense_den, device="cpu", fused=True)


@pytest.mark.parametrize("leaky", [0.0, 0.1])
def test_k9_kernel_order_matches_plain_at_the_bench_graph(bench_moore, leaky):
    """The same at the `dense` path's graph (E = 4224 expanded states: four or
    five columns per thread, so the per-thread shares and both butterflies
    of the block sums carry real terms), against the plain versions."""
    tg = bench_moore
    assert (tg.num_orig, tg.num_exp, tg.real_exp, tg.nnz) == (2176, 4224, 4156, 12376)
    y = np.random.default_rng(5).normal(size=(2, 4, tg.num_pdfs)).astype(np.float32)
    out = _k9_emulated_and_plain(tg, y, leaky)
    for what in ("logc", "sigma_hats", "gout"):
        _k9_close(what, *out[what])


def _moore_with_unentered_states(seed=3, S=24, real_orig=20, real_exp=37, E=40, P=6):
    """A Moore graph (torch package's DenseDenGraph) in which original states
    0 and 5 are entered by no expanded state but have out-arcs, state 0's
    50 times heavier than any other, and E - real_exp expanded states are
    padding (orig_of_exp 0, empty V columns)."""
    from torchain_tpu_torch.graphs import DenseDenGraph

    rng = np.random.default_rng(seed)
    entered = np.setdiff1d(np.arange(real_orig), [0, 5])
    orig = np.zeros(E, np.int32)
    orig[:real_exp] = np.sort(np.concatenate(
        [entered, rng.choice(entered, real_exp - entered.size)]))
    V = np.zeros((S, E), np.float32)
    for e in range(real_exp):
        src = rng.choice(real_orig, size=3, replace=False)
        V[src, e] = rng.random(3) + 0.1
    V[0] *= 50.0
    V[[0, 5], rng.choice(real_exp, 2, replace=False)] = 5.0  # out-arcs for both
    init = np.zeros(S, np.float32)
    init[:real_orig] = rng.random(real_orig) + 0.1
    return DenseDenGraph(num_pdfs=P, num_orig=S, num_exp=E, real_orig=real_orig,
                         real_exp=real_exp, V=V, orig_of_exp=orig,
                         pdf_of_exp=(np.arange(E) % P).astype(np.int32),
                         init_exp=np.zeros(E, np.float32), initial_probs=init / init.sum())


@pytest.mark.parametrize("leaky", [0.0, 0.1])
def test_k9_d_and_bh_leave_out_unentered_and_padded_states(leaky):
    """The traps of carrying bh over the original states.  d must be the
    maximum of nb = v @ E_mat^T, as the TPU kernel takes it: over the
    states some real expanded state enters, and 0 where padded expanded
    states exist; here v of state 0, entered by none, is larger in every
    frame.  (gout does not show a wrong d: G takes its log back.)  The
    padded expanded states get gout = 0 exactly, here with pe non-zero on
    them.  The emulated kernels agree with the plain versions, and end to
    end with ops/den_dense.py, which multiplies E_mat."""
    tg = TDense.from_host(_moore_with_unentered_states(), device="cpu", fused=True)
    T_, B_ = 6, 2
    rng = np.random.default_rng(8)
    pe = torch.as_tensor(rng.random((T_, B_, tg.num_exp)).astype(np.float32) + 0.05)
    logc, sig = tdp.dense_forward_plain(pe, tg, leaky)
    ymax_t = torch.zeros(T_, B_)
    F = torch.cumsum(logc, 0)
    fscale = torch.cat([F.new_zeros((1, B_)), F[:-1]]) - (F[-1] + (
        math.log1p(leaky) if leaky > 0.0 else 0.0))
    ds = []
    args = (pe, tg, sig, fscale, ymax_t, leaky)
    gout_e, gout_p = emulate_dense_backward(*args, ds=ds), tdp.dense_backward_plain(*args)
    _k9_close("gout", gout_e, gout_p)
    assert (gout_e[..., tg.real_exp:] == 0).all() and (gout_p[..., tg.real_exp:] == 0).all()
    _k9_close("logc", emulate_dense_forward(pe, tg, leaky)[0], logc)
    # d as the TPU kernel takes it (_bwd_kernel: nb = v @ E_mat^T)
    bh = torch.ones(B_, tg.num_exp)
    for t, d_e in zip(range(T_ - 1, 0, -1), ds):
        v = tdd.leak_t((pe[t] * bh) @ tg.V.T, tg.init_orig, leaky)
        nb = v @ tg.E_mat.T
        d = nb.max(-1).values
        assert (v.max(-1).values > 2 * d).all()  # the trap is armed: v[0] is larger
        np.testing.assert_allclose(d_e.numpy(), d.numpy(), rtol=1e-5)
        bh = nb / d[:, None]
    # end to end from the same y: the emulation against den_dense's gamma
    y = torch.as_tensor(rng.normal(size=(B_, T_, tg.num_pdfs)).astype(np.float32))
    _, res = tdd.den_forward(y, tg, leaky)
    out = _k9_emulated_and_plain(tg, y.numpy(), leaky)
    _k9_close("logc", out["end_to_end"][0], res["logc"])
    _k9_close("gamma", out["end_to_end"][2], tdd.den_backward(tg, res, leaky))
