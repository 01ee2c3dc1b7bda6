"""Denominator forward-backward of the PyTorch port (ops/den_resident.py:
the plain versions of kernels K1 and K2, which the wrappers run on CPU
tensors) against the JAX package's den_resident Pallas kernels (interpret
mode on the CPU) and the float64 NumPy oracle.

Same graph and the same numpy log-probs on both sides.  Tolerance: atol
2e-4 on log Z and the occupancies (as tests/test_den_resident.py holds the
Pallas kernels to the XLA references): both sides are float32 with sums in
another order, carried through T per-frame renormalisations."""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp
import torch

import torchain_tpu.graphs as jgraphs
import torchain_tpu_torch.graphs as tgraphs
from torchain_tpu.ops import den_resident as jdr
from torchain_tpu.ops import oracle
from torchain_tpu_torch.ops import den_resident as tdr

ATOL = 2e-4


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
    # LM pruning that breaks bigram closure: states with more distinct
    # in-pdfs than slots are split into clones
    "clone_split": dict(order=3, phones=5, ctx=2, seed=5, n_sents=60),
}


def _both(name, leaky, B=3, T=7, seed=1):
    kw = GRAPHS[name]
    jg = jdr.DeviceResidentDenGraph.from_host(
        _graph(jgraphs, **kw), pad_to=8, dtype=jnp.float32
    )
    host = _graph(tgraphs, **kw)
    tg = tdr.DeviceResidentDenGraph.from_host(host, pad_to=8, device="cpu")
    rng = np.random.default_rng(seed)
    y = rng.normal(size=(B, T, tg.num_pdfs)).astype(np.float32)
    z_j, res_j = jdr.den_forward(jnp.asarray(y), jg, leaky)
    gamma_j = jdr.den_backward(jg, res_j, leaky)
    z_t, res_t = tdr.den_forward(torch.as_tensor(y), tg, leaky)
    gamma_t = tdr.den_backward(tg, res_t, leaky)
    return host, tg, y, (np.asarray(z_j), np.asarray(gamma_j)), (z_t.numpy(), gamma_t.numpy())


@pytest.mark.parametrize("leaky", [0.0, 0.1])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_den_matches_jax_resident(name, leaky):
    host, tg, y, (z_j, g_j), (z_t, g_t) = _both(name, leaky)
    if name == "clone_split":
        assert tg.num_states > tg.real_states  # clones appended
    np.testing.assert_allclose(z_t, z_j, atol=ATOL)
    np.testing.assert_allclose(g_t, g_j, atol=ATOL)


@pytest.mark.parametrize("leaky", [0.0, 0.1])
def test_den_matches_oracle(leaky):
    host, tg, y, _, (z_t, g_t) = _both("clone_split", leaky, B=2, T=6, seed=3)
    for b in range(y.shape[0]):
        z_ref, g_ref = oracle.den_forward_backward(host, y[b], leaky)
        np.testing.assert_allclose(z_t[b], z_ref, atol=ATOL)
        np.testing.assert_allclose(g_t[b], g_ref, atol=ATOL)


def test_cpu_wrappers_run_plain_versions_without_counting():
    """On CPU tensors the K1/K2 wrappers run the plain versions; the launch
    counters move only where a kernel is launched."""
    tg = tdr.DeviceResidentDenGraph.from_host(
        _graph(tgraphs, **GRAPHS["bigram"]), pad_to=8, device="cpu"
    )
    y = torch.as_tensor(np.random.default_rng(0).normal(size=(2, 5, tg.num_pdfs)),
                        dtype=torch.float32)
    n_f, n_b = tdr.den_forward_kernel.launches, tdr.den_backward_kernel.launches
    z, res = tdr.den_forward(y, tg, 0.1)
    gamma = tdr.den_backward(tg, res, 0.1)
    assert (tdr.den_forward_kernel.launches, tdr.den_backward_kernel.launches) == (n_f, n_b)
    # the occupancies of each frame sum to one
    np.testing.assert_allclose(gamma.sum(-1).numpy(), 1.0, atol=ATOL)
    assert torch.isfinite(z).all()


def test_dead_slots_emit_nothing():
    """Slots no arc enters have slot_pdf -1 and must get emission 0, not
    p[:, 0] (the K1 trap)."""
    tg = tdr.DeviceResidentDenGraph.from_host(
        _graph(tgraphs, **GRAPHS["bigram"]), pad_to=8, device="cpu"
    )
    assert (tg.slot_pdf < 0).any()
    p = torch.rand(2, tg.num_pdfs) + 1.0
    pe = tdr._emissions(p, tg.slot_pdf)
    assert (pe[:, tg.slot_pdf < 0] == 0).all()
    assert (pe[:, tg.slot_pdf >= 0] > 0).all()
