"""`auto_den_graph` of the PyTorch port: the choice of the denominator form
by sizes, in the JAX package's order (slot-dense resident kernels K1/K2
where a sequence's carried state fits a block's shared memory, else the
dense Moore form fused, K9f/K9b, within the V budget, else the sparse scan
of ops/den_scan.py), and the chain loss through each form it picks against
the resident form's and against the JAX package's chain_loss with the form
its own `auto_den_graph` picks off the accelerator (run there as its own
tests run it on the CPU).

The library's shared-memory counts and the card's limit are stood in for
on the CPU: `den_shared_limit` is monkeypatched to a small limit and
`kernels.entry` to a stub whose counts mirror csrc/den_resident.cu's and
csrc/den_dense.cu's `layout` (the mirror is held to the counts
ops/den_resident.py and ops/den_pallas.py document for the shipped graphs).

Tolerances, as tests/test_torch_den_dense.py holds the den forms to the
JAX package: the loss and every aux value rtol 1e-5, the gradients rtol
1e-4, atol 1e-6 (float32 on both sides, sums in another order and, between
the forms, in another semiring)."""

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
from torchain_tpu.ops import device_graphs as jdg
from torchain_tpu_torch import kernels
from torchain_tpu_torch.ops import den_resident as tdr
from torchain_tpu_torch.ops import device_graphs as tdg

PAD = 8
#: a left-biphone graph over 8 phones with a bigram LM: its 80 pdfs outnumber
#: its states (17; 40 slot-dense with the clones, 24 x 56 dense at PAD), as
#: a large tree's do, so that the resident form carries more than the dense
CORPUS = dict(num_utts=6, num_phones=8, feat_dim=8, utt_frames_out=(9, 12), seed=6,
              context_width=2, lm_order=2, lm_extra_states=0)
OPTS = dict(l2_regularize=5e-4, leaky_hmm_coefficient=0.1, xent_regularize=0.1)


def _up16(n):
    return (n + 15) // 16 * 16


def _resident_bytes(backward, S, K, P, nnz, live, staged):
    """csrc/den_resident.cu `layout` without the staged tables: K1 sigma,
    alpha and two p rows, K2 bh, two ah rows and one p row, and two
    reduction arrays of 32 floats."""
    assert staged == 0
    rows, prows = (2, 1) if backward else (1, 2)
    return _up16(4 * S) + rows * _up16(4 * K * S) + prows * _up16(4 * P) + 2 * 4 * 32


def _dense_bytes(backward, S, E, nnz, real_exp, staged):
    """csrc/den_dense.cu `layout` without the staged tables: K9f sigma and
    two pe rows, K9b also a sig row, and their reduction arrays."""
    assert staged == 0
    return (_up16(4 * S) + (_up16(4 * S) if backward else 0) + 2 * _up16(4 * E)
            + (3 if backward else 2) * 4 * 32)


def test_the_stub_counts_are_the_documented_ones():
    """The mirrors give the carried bytes ops/den_resident.py `shared_plan`
    and ops/den_pallas.py `shared_plan` document for the shipped graphs."""
    assert _resident_bytes(0, 2176, 2, 80, 0, 0, 0) == 27_008
    assert _resident_bytes(1, 2176, 2, 80, 0, 0, 0) == 44_096
    assert _resident_bytes(0, 3968, 2, 1680, 0, 0, 0) == 61_312
    assert _resident_bytes(1, 3968, 2, 1680, 0, 0, 0) == 86_336
    assert _dense_bytes(0, 2176, 4224, 0, 0, 0) == 42_752
    assert _dense_bytes(1, 2176, 4224, 0, 0, 0) == 51_584


@pytest.mark.parametrize("backward", [0, 1])
def test_the_host_copy_of_the_carried_state_is_the_mirror(backward):
    """ops/den_resident.py `carried_bytes`, which `auto_den_graph` holds the
    CPU's resident form to, gives the mirror's count over a sweep of sizes
    (the card test holds it to the library's own)."""
    for S in (8, 136, 2176, 3968, 11520, 32640):
        for K in (1, 2, 3):
            for P in (1, 80, 83, 1680):
                assert tdr.carried_bytes(backward, S, K, P) == \
                    _resident_bytes(backward, S, K, P, 0, 0, 0)


def _stub(monkeypatch, limit):
    """The card's limit set to `limit` bytes and a library that counts as
    the kernels do; returns the list of (library, entry, args) asked."""
    asked = []
    counts = dict(den_shared_bytes=_resident_bytes, dense_shared_bytes=_dense_bytes)

    def entry(lib, fn):
        def call(*args):
            asked.append((lib, fn, args))
            return counts[fn](*args)
        return call

    monkeypatch.setattr(kernels, "entry", entry)
    monkeypatch.setattr(tdg, "den_shared_limit", lambda device: limit)
    return asked


@pytest.fixture(scope="module")
def sides():
    out = []
    for pkg_data, pkg_graphs in ((jdata, jgraphs), (tdata, tgraphs)):
        c = pkg_data.synthetic_dataset(**CORPUS)
        ds = pkg_data.ChainDataset(
            c.utts, c.tree, c.norm_fst, chunk_frames_out=9, left_context=2, right_context=2,
            sup_opts=pkg_graphs.SupervisionOptions(left_tolerance=2, right_tolerance=2))
        out.append((c, next(ds.batches(3, shuffle=False)).sup))
    return out


@pytest.mark.parametrize("max_slots", [2, 1], ids=["slots2", "clones"])
def test_slot_sizes_are_those_of_the_built_graph(sides, max_slots):
    """`slot_sizes` gives the padded states and slots `from_host` builds,
    also where states are split into clones, without building V."""
    c = sides[1][0]
    g = tdr.DeviceResidentDenGraph.from_host(c.den_graph, pad_to=PAD, max_slots=max_slots,
                                             device="cpu")
    assert tdr.slot_sizes(c.den_graph, PAD, max_slots) == (g.num_states, g.num_slots)
    if max_slots == 1:
        assert g.num_states > tdr.slot_sizes(c.den_graph, PAD, 2)[0]


@pytest.mark.parametrize("fall_through", [False, True], ids=["resident", "fall_through"])
def test_auto_den_graph_lays_out_the_slots_once(sides, monkeypatch, fall_through):
    """`auto_den_graph` computes the slot layout once, whichever form it
    picks: the resident form is built on it, and the fall-through takes E
    from its distinct (dst, pdf) pairs, which are the dense Moore form's
    expanded states."""
    g = sides[1][0].den_graph
    calls = []
    real = tdg.slot_layout

    def counted(*a, **k):
        calls.append(a)
        return real(*a, **k)

    monkeypatch.setattr(tdg, "slot_layout", counted)
    monkeypatch.setattr(tdr, "slot_layout", counted)
    if fall_through:  # below the resident form's carried state, above the dense one's
        S_pad, K = tdr.slot_sizes(g, PAD)
        _stub(monkeypatch, _resident_bytes(1, S_pad, K, g.num_pdfs, 0, 0, 0) - 1)
    calls.clear()
    den = tops.auto_den_graph(g, pad_to=PAD, device="cpu")
    assert len(calls) == 1
    assert len(real(g).uniq_pdf) == tgraphs.make_dense_den_graph(g, pad_to=PAD).real_exp
    want = tops.DeviceDenseDenGraph if fall_through else tdr.DeviceResidentDenGraph
    assert isinstance(den, want)


def test_the_cpu_keeps_the_resident_form_and_asks_no_library(sides, monkeypatch):
    def refuse(*a):
        raise AssertionError("the library was asked on the CPU")

    monkeypatch.setattr(kernels, "entry", refuse)
    g = tops.auto_den_graph(sides[1][0].den_graph, pad_to=PAD, device="cpu")
    assert isinstance(g, tdr.DeviceResidentDenGraph)
    assert tdg.den_shared_limit("cpu") is None
    assert tdg.den_form_fits("resident", (1 << 20, 2, 1 << 20), "cpu")


def test_the_fit_test_holds_each_kernel_of_a_form_to_the_limit(monkeypatch):
    """K1 and K2 (K9f and K9b) must both fit: K2 (K9b) carries more, so a
    limit between the two refuses the form; 16-bit indices bound both."""
    asked = _stub(monkeypatch, 44_095)
    assert not tdg.den_form_fits("resident", (2176, 2, 80), "cuda")
    assert {a[2][0] for a in asked} == {0, 1}
    monkeypatch.setattr(tdg, "den_shared_limit", lambda device: 44_096)
    assert tdg.den_form_fits("resident", (2176, 2, 80), "cuda")
    assert tdg.den_form_fits("dense", (2176, 4224), "cuda") is False  # K9b 51,584
    monkeypatch.setattr(tdg, "den_shared_limit", lambda device: 1 << 30)
    assert tdg.den_form_fits("dense", (2176, 4224), "cuda")
    assert not tdg.den_form_fits("resident", (32768, 2, 80), "cuda")
    assert not tdg.den_form_fits("dense", (128, 65536), "cuda")


def _loss(den, sup, y, x):
    yt = torch.tensor(y, requires_grad=True)
    xt = torch.tensor(x, requires_grad=True)
    loss, aux = tops.chain_loss(yt, xt, den, sup, tops.ChainLossOptions(**OPTS))
    loss.backward()
    return float(loss.detach()), {k: float(v.detach()) for k, v in aux.items()}, \
        yt.grad.numpy(), xt.grad.numpy()


def _close(got, want):
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    for k in want[1]:
        np.testing.assert_allclose(got[1][k], want[1][k], rtol=1e-5, atol=1e-7, err_msg=k)
    np.testing.assert_allclose(got[2], want[2], rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(got[3], want[3], rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("form", ["dense", "scan"])
def test_auto_den_graph_falls_through_by_sizes(sides, monkeypatch, form):
    """With a limit below the resident form's carried state and above the
    dense form's, `auto_den_graph` picks the fused dense Moore form; with
    the V budget also below this graph's V, the sparse scan.  The chain
    loss and its gradients through the form picked equal the resident
    form's, and the JAX package's chain_loss through the form its own
    `auto_den_graph` picks off the accelerator with that V budget."""
    (jc, jb), (tc, tb) = sides
    S_pad, K = tdr.slot_sizes(tc.den_graph, PAD)
    dense = tgraphs.make_dense_den_graph(tc.den_graph, pad_to=PAD)
    S, E = dense.num_orig, dense.num_exp
    limit = _resident_bytes(1, S_pad, K, tc.den_graph.num_pdfs, 0, 0, 0) - 1
    assert _dense_bytes(1, S, E, 0, 0, 0) <= limit  # a limit between the two forms
    asked = _stub(monkeypatch, limit)
    budget = tdg.DENSE_V_BYTES_THRESHOLD if form == "dense" else S * E * 4 - 1
    monkeypatch.setattr(tdg, "DENSE_V_BYTES_THRESHOLD", budget)
    den = tops.auto_den_graph(tc.den_graph, pad_to=PAD, device="cpu")
    if form == "dense":
        assert isinstance(den, tops.DeviceDenseDenGraph) and den.fused
        assert (den.num_orig, den.num_exp) == (S, E)
        assert {a[1] for a in asked} == {"den_shared_bytes", "dense_shared_bytes"}
    else:
        assert isinstance(den, tops.DeviceDenGraph)
        # the V budget is tested first: K9's carried state is not asked for
        assert {a[1] for a in asked} == {"den_shared_bytes"}

    B, T, P = 3, 9, tc.tree.num_pdfs
    rng = np.random.default_rng(5)
    y = rng.normal(size=(B, T, P)).astype(np.float32)
    x = rng.normal(size=(B, T, P)).astype(np.float32)
    tsup = tops.DeviceSupervision.from_host(tb, device="cpu").with_kernel_tables()
    got = _loss(den, tsup, y, x)
    resident = tdr.DeviceResidentDenGraph.from_host(tc.den_graph, pad_to=PAD, device="cpu")
    _close(got, _loss(resident, tsup, y, x))

    jden = jdg.auto_den_graph(jc.den_graph, pad_to=PAD, max_v_bytes=budget)
    assert isinstance(jden, jdg.DeviceDenseDenGraph if form == "dense" else jdg.DeviceDenGraph)
    jsup = jops.DeviceSupervision.from_host(jb)

    def jloss(y, x):
        return jops.chain_loss(y, x, jden, jsup, jops.ChainLossOptions(**OPTS))

    (l_j, aux_j), (dy_j, dx_j) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(y), jnp.asarray(x))
    _close(got, (float(l_j), {k: float(v) for k, v in aux_j.items()}, np.asarray(dy_j),
                 np.asarray(dx_j)))
