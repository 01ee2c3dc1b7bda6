"""The denominator forms of the PyTorch port with no kernel, against the JAX
package: the padded-table form (ops/den_table.py), the alpha-checkpointed
scan (ops/den_scan.py `den_forward_checkpointed` /
`den_backward_checkpointed`), and the de Bruijn lift (graphs/debruijn.py,
ops/den_debruijn.py); the chain loss's dispatch to each; and
`auto_den_graph`'s choice of the lift.

Same graph and numpy log-probs on both sides; the JAX functions are called
directly (no `jax.grad` through them: their CPU compile is the slow part).
Tolerances, as the JAX package's own tests hold these forms: log Z and the
occupancies atol 2e-4 against the scan and the float64 oracle (float32 sums
in another order, or in another semiring, over T frames); the checkpointed
scan against the plain one 1e-5 (the same ops, recomputed); each form
against its JAX counterpart 1e-5 (the same ops in float32, another
library's sums); the compiler's tables exactly.  The chain loss: the loss
and each aux value rtol 1e-5, the gradients rtol 1e-4, atol 1e-6, as
tests/test_torch_den_dense.py holds the other forms."""

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
from torchain_tpu.ops import den_debruijn as jdb
from torchain_tpu.ops import den_scan as jds
from torchain_tpu.ops import den_table as jdt
from torchain_tpu.ops import oracle
from torchain_tpu.ops.device_graphs import DeviceDenGraph as JSparse
from torchain_tpu_torch.ops import den_debruijn as tdb
from torchain_tpu_torch.ops import den_scan as tds
from torchain_tpu_torch.ops import den_table as tdt
from torchain_tpu_torch.ops import device_graphs as tdg

ATOL = 2e-4
SAME = 1e-5
#: (num_phones, ngram_order, context_width, extra_states): a monophone and a
#: left-biphone case of tests/test_debruijn.py's CASES
CASES = {"mono_bigram": (3, 2, 1, 10), "biphone_4gram": (4, 4, 2, 60)}
B, T = 3, 8


def _sents(num_phones, seed=0, n=40):
    rng = np.random.default_rng(seed)
    return [list(map(int, rng.integers(1, num_phones + 1, size=rng.integers(3, 9))))
            for _ in range(n)]


def _build(pkg, num_phones, order, ctx_w, extra, start_boost=0.01):
    lm = pkg.estimate_phone_lm(
        _sents(num_phones), pkg.PhoneLmOptions(ngram_order=order, num_extra_lm_states=extra))
    tree = pkg.ContextTree(num_phones, context_width=ctx_w)
    graph = pkg.compile_den_graph(pkg.make_den_fst(lm, tree), tree.num_pdfs,
                                  start_boost=start_boost)
    return lm, tree, graph


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    j, t = (_build(pkg, *CASES[request.param]) for pkg in (jgraphs, tgraphs))
    rng = np.random.default_rng(1)
    y = (rng.normal(size=(B, T, t[1].num_pdfs)) * 0.8).astype(np.float32)
    return dict(j=j, t=t, y=y, name=request.param)


def _scan_jax(case, leaky):
    graph = case["j"][2]
    g = JSparse.from_host(graph)
    y = jnp.asarray(case["y"])
    z, al = jds.den_forward(y, g, leaky)
    return np.asarray(z), np.asarray(jds.den_backward(y, g, z, al, leaky))


def _close(got, want, atol, what):
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=atol, err_msg=f"{what} log Z")
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=atol, err_msg=f"{what} gamma")


# ---------------------------------------------------------------------------
# the padded-table form
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("leaky", [0.0, 0.1])
def test_table_form_matches_jax_and_the_scan(case, leaky):
    tg = tdt.DeviceDenTableGraph.from_host(case["t"][2], device="cpu")
    jg = jdt.DeviceDenTableGraph.from_host(case["j"][2])
    for f in ("in_src", "in_pdf", "in_logw", "out_dst", "out_pdf", "out_logw", "log_init"):
        np.testing.assert_array_equal(getattr(tg, f).numpy(), np.asarray(getattr(jg, f)), f)
    assert (tg.max_in, tg.max_out) == (jg.max_in, jg.max_out)
    yt, yj = torch.as_tensor(case["y"]), jnp.asarray(case["y"])
    z, al = tdt.den_forward(yt, tg, leaky)
    got = (z.numpy(), tdt.den_backward(yt, tg, z, al, leaky).numpy())
    zj, alj = jdt.den_forward(yj, jg, leaky)
    _close(got, (np.asarray(zj), np.asarray(jdt.den_backward(yj, jg, zj, alj, leaky))),
           SAME, "table vs JAX")
    _close(got, _scan_jax(case, leaky), ATOL, "table vs scan")


def test_table_pad_multiple_rounds_the_widths(case):
    tg = tdt.DeviceDenTableGraph.from_host(case["t"][2], pad_multiple=8, device="cpu")
    assert tg.max_in % 8 == 0 and tg.max_out % 8 == 0
    yt = torch.as_tensor(case["y"])
    z, al = tdt.den_forward(yt, tg, 0.1)
    got = (z.numpy(), tdt.den_backward(yt, tg, z, al, 0.1).numpy())
    _close(got, _scan_jax(case, 0.1), ATOL, "padded table vs scan")


# ---------------------------------------------------------------------------
# the alpha-checkpointed scan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("every", [4, 5, 10])
@pytest.mark.parametrize("leaky", [0.0, 0.1])
def test_checkpointed_scan_matches_the_plain_scan_and_jax(case, every, leaky):
    Tc = 20  # divisible by every case
    rng = np.random.default_rng(7)
    y = (rng.normal(size=(2, Tc, case["t"][1].num_pdfs)) * 0.8).astype(np.float32)
    g = tdg.DeviceDenGraph.from_host(case["t"][2], device="cpu")
    yt = torch.as_tensor(y)
    z, chk = tds.den_forward_checkpointed(yt, g, leaky, every)
    assert chk.shape == (Tc // every, 2, g.num_states)
    gam = tds.den_backward_checkpointed(yt, g, z, chk, leaky, every)
    z0, al = tds.den_forward(yt, g, leaky)
    np.testing.assert_allclose(chk.numpy(), al[:-1:every].numpy(), rtol=0, atol=SAME)
    _close((z.numpy(), gam.numpy()), (z0.numpy(), tds.den_backward(yt, g, z0, al, leaky).numpy()),
           SAME, "checkpointed vs plain")
    jg, yj = JSparse.from_host(case["j"][2]), jnp.asarray(y)
    zj, chj = jds.den_forward_checkpointed(yj, jg, leaky, every)
    np.testing.assert_allclose(chk.numpy(), np.asarray(chj), rtol=0, atol=SAME)
    _close((z.numpy(), gam.numpy()),
           (np.asarray(zj),
            np.asarray(jds.den_backward_checkpointed(yj, jg, zj, chj, leaky, every))),
           SAME, "checkpointed vs JAX")


def test_checkpointed_scan_refuses_an_indivisible_length(case):
    g = tdg.DeviceDenGraph.from_host(case["t"][2], device="cpu")
    with pytest.raises(ValueError, match="not divisible"):
        tds.den_forward_checkpointed(torch.as_tensor(case["y"]), g, 0.1, every=3)


# ---------------------------------------------------------------------------
# the de Bruijn lift
# ---------------------------------------------------------------------------

FIELDS = ("num_phones", "num_pdfs", "m", "sigma", "tail_len", "log_continue", "log_end",
          "W3", "pdf0_group", "pdf1_group", "init_bnd", "init_loop", "valid", "cls")


def test_debruijn_compiler_tables_equal_jax(case):
    (jlm, jtree, _), (tlm, ttree, _) = case["j"], case["t"]
    for boost in (0.01, 1.0):
        jd = jgraphs.make_debruijn_den_graph(jlm, jtree, start_boost=boost)
        td = tgraphs.make_debruijn_den_graph(tlm, ttree, start_boost=boost)
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(td, f), getattr(jd, f), f)
        assert td.affine_pdf_specs() == jd.affine_pdf_specs()
    jfst, jinit = jgraphs.materialize_lift_fst(jd)
    tfst, tinit = tgraphs.materialize_lift_fst(td)
    np.testing.assert_array_equal(tinit, jinit)
    assert tfst.num_states == jfst.num_states
    assert sorted((s, a.label, a.weight, a.dst) for s, a in tfst.all_arcs()) == \
        sorted((s, a.label, a.weight, a.dst) for s, a in jfst.all_arcs())


def _lift(case, leaky, boost=0.01, onehot=False):
    (jlm, jtree, _), (tlm, ttree, _) = case["j"], case["t"]
    jd = jgraphs.make_debruijn_den_graph(jlm, jtree, start_boost=boost)
    td = tgraphs.make_debruijn_den_graph(tlm, ttree, start_boost=boost)
    tg = tdb.DeviceDeBruijnDenGraph.from_host(td, device="cpu")
    if onehot:  # the one-hot product of a tree without affine groups
        oh = lambda grp: torch.zeros((td.num_pdfs, td.num_groups)).index_put_(  # noqa: E731
            (torch.as_tensor(grp).long(), torch.arange(td.num_groups)), torch.tensor(1.0))
        tg = tdb.DeviceDeBruijnDenGraph(**{**tg.__dict__, "spec0": None, "spec1": None,
                                           "onehot0": oh(td.pdf0_group),
                                           "onehot1": oh(td.pdf1_group)})
    yt = torch.as_tensor(case["y"])
    z, res = tdb.den_forward(yt, tg, leaky)
    return td, jd, (z.numpy(), tdb.den_backward(yt, tg, z, res, leaky).numpy())


@pytest.mark.parametrize("onehot", [False, True], ids=["affine", "onehot"])
@pytest.mark.parametrize("leaky", [0.0, 0.1])
def test_debruijn_recursion_matches_jax(case, leaky, onehot):
    _, jd, got = _lift(case, leaky, onehot=onehot)
    jg, yj = jdb.DeviceDeBruijnDenGraph.from_host(jd), jnp.asarray(case["y"])
    zj, rj = jdb.den_forward(yj, jg, leaky)
    _close(got, (np.asarray(zj), np.asarray(jdb.den_backward(yj, jg, zj, rj, leaky))),
           SAME, "de Bruijn vs JAX")
    np.testing.assert_allclose(got[1].sum(-1), 1.0, atol=1e-4)


@pytest.mark.parametrize("leaky", [0.0, 0.1])
def test_debruijn_quotient_matches_the_scan(case, leaky):
    """A delta initial distribution (start_boost 1) removes the split of the
    initial mass over the lift: the lift and the FST den graph agree."""
    num_phones, order, ctx_w, extra = CASES[case["name"]]
    _, _, graph = _build(tgraphs, num_phones, order, ctx_w, extra, start_boost=1.0)
    _, _, got = _lift(case, leaky, boost=1.0)
    g = tdg.DeviceDenGraph.from_host(graph, device="cpu")
    yt = torch.as_tensor(case["y"])
    z, al = tds.den_forward(yt, g, leaky)
    _close(got, (z.numpy(), tds.den_backward(yt, g, z, al, leaky).numpy()), ATOL,
           "de Bruijn vs scan")


def test_debruijn_matches_the_oracle_on_the_materialized_lift(case):
    td, _, got = _lift(case, 0.07)
    fst, init = tgraphs.materialize_lift_fst(td)
    graph = tgraphs.compile_den_graph(fst, td.num_pdfs, initial_probs=init)
    for b in range(B):
        oz, og = oracle.den_forward_backward(graph, case["y"][b], leaky=0.07)
        assert got[0][b] == pytest.approx(oz, abs=ATOL)
        np.testing.assert_allclose(got[1][b], og, atol=ATOL)


def test_a_triphone_tree_is_refused_by_the_lift_and_passed_over():
    """The JAX compiler reads tree.pdf(q, cls, prev) alone, so it would
    lift a tree with right context to another graph: the port refuses it,
    and `auto_den_graph` on the card passes it over."""
    corpus = tdata.synthetic_dataset(num_utts=8, num_phones=4, feat_dim=8,
                                     utt_frames_out=(9, 12), seed=3, lm_order=2)
    rng = np.random.default_rng(0)
    # [pdf class, phone, left, right]: pdfs that vary with the right context
    tree = tgraphs.TiedTree(rng.integers(0, 12, size=(2, 5, 5, 5)), 4)
    assert tree.right_dependent(0) or tree.right_dependent(1)
    left = tgraphs.TiedTree(tree.pdf_map[..., :1], 4)
    assert not (left.right_dependent(0) or left.right_dependent(1))
    assert tdg.debruijn_contexts(corpus.phone_lm, left) == 25
    with pytest.raises(ValueError, match="right context"):
        tgraphs.make_debruijn_den_graph(corpus.phone_lm, tree)
    assert tdg.debruijn_contexts(corpus.phone_lm, tree) is None
    assert tdg.debruijn_contexts(corpus.phone_lm, corpus.tree) == 5


# ---------------------------------------------------------------------------
# auto_den_graph's choice of the lift, and the chain loss through every form
# ---------------------------------------------------------------------------

CORPUS = dict(num_utts=6, num_phones=4, feat_dim=8, utt_frames_out=(9, 12), seed=6,
              lm_order=3, lm_extra_states=30)
OPTS = dict(l2_regularize=5e-4, leaky_hmm_coefficient=0.1, xent_regularize=0.1)


@pytest.fixture(scope="module")
def sides():
    out = []
    for pkg_data, pkg_graphs in ((jdata, jgraphs), (tdata, tgraphs)):
        c = pkg_data.synthetic_dataset(**CORPUS)
        ds = pkg_data.ChainDataset(
            c.utts, c.tree, c.norm_fst, chunk_frames_out=10, left_context=2, right_context=2,
            sup_opts=pkg_graphs.SupervisionOptions(left_tolerance=2, right_tolerance=2))
        out.append((c, next(ds.batches(3, shuffle=False)).sup))
    return out


def _refuse_resident(monkeypatch, on_card: bool):
    real = tdg.den_form_fits
    monkeypatch.setattr(tdg, "den_form_fits",
                        lambda form, sizes, device: form != "resident" and real(form, sizes, device))
    monkeypatch.setattr(tdg, "_on_card", lambda device: on_card)


@pytest.mark.parametrize("on_card", [True, False], ids=["card", "cpu"])
def test_auto_den_graph_takes_the_lift_on_the_card_only(sides, monkeypatch, on_card):
    """Where the resident form does not fit: the lift on the card (given the
    LM and tree, C within the budget), never on the CPU; past the budget
    the dense Moore form."""
    c = sides[1][0]
    _refuse_resident(monkeypatch, on_card)
    den = tops.auto_den_graph(c.den_graph, pad_to=8, device="cpu", phone_lm=c.phone_lm,
                              tree=c.tree)
    want = tops.DeviceDeBruijnDenGraph if on_card else tops.DeviceDenseDenGraph
    assert isinstance(den, want)
    if on_card:
        assert den.num_contexts == 5 ** 2
        monkeypatch.setattr(tdg, "DEBRUIJN_MAX_CONTEXTS", 24)
        den = tops.auto_den_graph(c.den_graph, pad_to=8, device="cpu", phone_lm=c.phone_lm,
                                  tree=c.tree)
        assert isinstance(den, tops.DeviceDenseDenGraph)
    assert isinstance(tops.auto_den_graph(c.den_graph, pad_to=8, device="cpu"),
                      tops.DeviceDenseDenGraph)


def _ckpt_graph(graph, every):
    return tdg.DeviceDenGraph.from_host(graph, device="cpu", checkpoint_every=every)


@pytest.mark.parametrize("form", ["table", "scan_ckpt", "debruijn"])
def test_chain_loss_dispatches_to_each_new_form(sides, form):
    """The loss and its gradients through each new form against the JAX
    package's chain_loss with its counterpart (the checkpointed scan: the
    JAX scan, which stores every alpha; the dispatch to the checkpointed
    variant is shown by its residuals)."""
    (jc, jb), (tc, tb) = sides
    if form == "table":
        jden = jdt.DeviceDenTableGraph.from_host(jc.den_graph)
        tden = tdt.DeviceDenTableGraph.from_host(tc.den_graph, device="cpu")
    elif form == "scan_ckpt":
        jden = JSparse.from_host(jc.den_graph)
        tden = _ckpt_graph(tc.den_graph, 5)
    else:
        jden = jdb.DeviceDeBruijnDenGraph.from_host(
            jgraphs.make_debruijn_den_graph(jc.phone_lm, jc.tree))
        tden = tdb.DeviceDeBruijnDenGraph.from_host(
            tgraphs.make_debruijn_den_graph(tc.phone_lm, tc.tree), device="cpu")
    jsup = jops.DeviceSupervision.from_host(jb)
    tsup = tops.DeviceSupervision.from_host(tb, device="cpu")
    rng = np.random.default_rng(3)
    y = rng.normal(size=(3, 10, jc.tree.num_pdfs)).astype(np.float32)
    x = rng.normal(size=y.shape).astype(np.float32)

    def jloss(y, x):
        return jops.chain_loss(y, x, jden, jsup, jops.ChainLossOptions(**OPTS))

    (l_j, aux_j), (dy_j, dx_j) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(y), jnp.asarray(x))
    yt = torch.tensor(y, requires_grad=True)
    xt = torch.tensor(x, requires_grad=True)
    from torchain_tpu_torch.ops.chain_loss import _den_forward

    _, res = _den_forward(yt.detach(), tden, 0.1)
    if form == "scan_ckpt":
        assert res["every"] == 5 and res["chk"].shape[0] == 2
    l_t, aux_t = tops.chain_loss(yt, xt, tden, tsup, tops.ChainLossOptions(**OPTS))
    l_t.backward()
    np.testing.assert_allclose(float(l_t.detach()), float(l_j), rtol=1e-5)
    for k in aux_j:
        np.testing.assert_allclose(float(aux_t[k].detach()), float(aux_j[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    np.testing.assert_allclose(yt.grad.numpy(), np.asarray(dy_j), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx_j), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("every,stored", [(5, "chk"), (10, "alphas"), (3, "alphas")])
def test_the_checkpointed_scan_is_taken_under_the_jax_condition(sides, every, stored):
    """every and T > every and T % every == 0 (torchain_tpu/ops/chain_loss.py):
    at T 10, a period of 5 checkpoints, of 10 or 3 stores every alpha."""
    from torchain_tpu_torch.ops.chain_loss import _den_forward

    y = torch.zeros(2, 10, sides[1][0].tree.num_pdfs)
    _, res = _den_forward(y, _ckpt_graph(sides[1][0].den_graph, every), 0.1)
    assert stored in res
