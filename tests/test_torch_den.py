"""Denominator forward-backward of the PyTorch port (ops/den_resident.py:
the plain versions of kernels K1 and K2, which the wrappers run on CPU
tensors) against the JAX package's den_resident Pallas kernels (interpret
mode on the CPU) and the float64 NumPy oracle.

Same graph and the same numpy log-probs on both sides.  Tolerance: atol
2e-4 on log Z and the occupancies (as tests/test_den_resident.py holds the
Pallas kernels to the XLA references): both sides are float32 with sums in
another order, carried through T per-frame renormalisations."""

import math

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


# ---------------------------------------------------------------------------
# V's compressed forms, and the kernels' order of summation
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def bench_trigram():
    """The host graph of chip_smoke.py's trigram path (bench.py's trigram
    configuration: 40 phones, 1000 extra LM states)."""
    import chip_smoke

    corpus = chip_smoke._corpus(0, tuple(sorted(chip_smoke.PATHS["trigram"]["corpus"].items())))
    return corpus.den_graph


def _u16(x: torch.Tensor) -> torch.Tensor:
    """The unsigned values of an int16 index tensor, as int64."""
    return x.long() & 0xFFFF if x.dtype == torch.int16 else x.long()


def _expand(offsets, idx, vals, shape, by_col: bool) -> np.ndarray:
    """A compressed form back to its dense matrix; asserts that each
    column's (row's) entries are in strictly increasing index order."""
    off, idx, vals = offsets.long().numpy(), _u16(idx).numpy(), vals.numpy()
    major = np.repeat(np.arange(off.size - 1), np.diff(off))
    for a, b in zip(off[:-1], off[1:]):
        assert np.all(np.diff(idx[a:b]) > 0)
    out = np.zeros(shape, np.float32)
    if by_col:
        out[idx, major] = vals
    else:
        out[major, idx] = vals
    return out


@pytest.mark.parametrize("max_slots", [2, 1], ids=["slots2", "clones"])
def test_compressed_forms_rebuild_V_exactly(bench_trigram, max_slots):
    """The CSC (K1's) and the CSR (K2's) expand to exactly V, clones and
    padding included; a clone's row in the CSR equals its original's."""
    g = tdr.DeviceResidentDenGraph.from_host(bench_trigram, max_slots=max_slots, device="cpu")
    V = g.V.numpy()
    S, KS = V.shape
    assert g.csc_rows.dtype == torch.int16 and g.csr_cols.dtype == torch.int16
    assert g.nnz == int(np.count_nonzero(V)) == g.csr_vals.shape[0]
    np.testing.assert_array_equal(
        _expand(g.csc_offsets, g.csc_rows, g.csc_vals, V.shape, by_col=True), V)
    np.testing.assert_array_equal(
        _expand(g.csr_offsets, g.csr_cols, g.csr_vals, V.shape, by_col=False), V)
    # padding: no entry in a padded state's row or in a dead slot's column
    off_r, off_c = g.csr_offsets.numpy(), g.csc_offsets.numpy()
    used = int(np.flatnonzero(np.diff(off_r)).max()) + 1
    assert used <= S and (np.diff(off_r)[used:] == 0).all()
    assert (np.diff(off_c)[g.slot_pdf.numpy() < 0] == 0).all()
    if max_slots == 1:
        assert g.num_slots == 1 and used > g.real_states  # clones appended
        rows = {}
        cols, vals = _u16(g.csr_cols).numpy(), g.csr_vals.numpy()
        for s in range(used):
            rows.setdefault(s, (tuple(cols[off_r[s]:off_r[s + 1]]),
                                tuple(vals[off_r[s]:off_r[s + 1]])))
        originals = {rows[s] for s in range(g.real_states)}
        assert all(rows[s] in originals for s in range(g.real_states, used))


def _fma(a, b, c):
    """float32 fma(a, b, c): the exact product (float64 holds it) plus c,
    rounded once to float32."""
    return (a.double() * b.double() + c.double()).float()


def _shares(x, N, y=None):
    """Thread j's share of a block sum over x [..., n] (times y [n] where
    given, by fma), summed over x[j], x[j + N], ... in that order: [..., N]."""
    n = x.shape[-1]
    R = -(-n // N)
    pad = lambda a: torch.nn.functional.pad(a, (0, R * N - n)).unflatten(-1, (R, N))  # noqa: E731
    xs = pad(x)
    ys = pad(y) if y is not None else None
    acc = x.new_zeros(x.shape[:-1] + (N,))
    for r in range(R):
        acc = _fma(xs[..., r, :], ys[r], acc) if y is not None else acc + xs[..., r, :]
    return acc


def _tree(shares):
    """The kernels' block sum of per-thread shares [..., N]: a butterfly over
    the 32 lanes of each warp, then over the warps' sums padded to 32."""
    x = shares.unflatten(-1, (-1, 32))
    for off in (16, 8, 4, 2, 1):
        x = x[..., :off] + x[..., off:2 * off]
    w = x[..., 0]
    w = torch.nn.functional.pad(w, (0, 32 - w.shape[-1]))
    for off in (16, 8, 4, 2, 1):
        w = w[..., :off] + w[..., off:2 * off]
    return w[..., 0]


def _walk(offsets, idx, vals, x):
    """out[..., m] = the fma chain over entry j of major index m in index
    order: acc = fma(vals[j], x[..., idx[j]], acc)."""
    off, idx = offsets.long(), _u16(idx)
    cnt = off[1:] - off[:-1]
    out = x.new_zeros(x.shape[:-1] + (cnt.shape[0],))
    for r in range(int(cnt.max()) if cnt.numel() else 0):
        has = cnt > r
        j = (off[:-1] + r).clamp(max=max(idx.shape[0] - 1, 0))
        out = torch.where(has, _fma(vals[j], x[..., idx[j]], out), out)
    return out


def emulate_forward(p, g, leaky, N=tdr.THREADS):
    """K1 as csrc/den_resident.cu computes it, walking the CSC."""
    T, B, _ = p.shape
    S, K = g.num_states, g.num_slots
    init, pdf = g.init, g.slot_pdf.long()

    def leak(sh):
        if leaky <= 0.0:
            return sh
        lt = leaky * _tree(_shares(sh, N))
        return _fma(lt[:, None], init, sh)

    sig = leak(init.expand(B, S).clone())
    logc, ah = p.new_empty((T, B)), p.new_empty((T, B, K * S))
    for t in range(T):
        h = _walk(g.csc_offsets, g.csc_rows, g.csc_vals, sig)
        a = torch.where(pdf >= 0, h * p[t][:, pdf.clamp(min=0)], torch.zeros(()))
        c = _tree(_shares(a, N))
        logc[t] = torch.log(c)
        ah[t] = a / c[:, None]
        sh = ah[t][:, :S]
        for k in range(1, K):
            sh = sh + ah[t][:, k * S:(k + 1) * S]
        sig = leak(sh)
    return logc, ah


def emulate_backward(p, ah, F, ymax, log_z, g, leaky, N=tdr.THREADS):
    """K2 as csrc/den_resident.cu computes it: the occupancies by the pdf
    CSR in slot order, v by the CSR of V in slot order."""
    T, B, P = p.shape
    S = g.num_states
    qoff, qslot = g.pdf_offsets.long(), g.pdf_slots.long()
    qcnt = qoff[1:] - qoff[:-1]
    pdf = g.slot_pdf.long()
    live = pdf >= 0
    bh = p.new_ones((B, S))
    G = p.new_full((B,), math.log1p(leaky) if leaky > 0.0 else 0.0)
    gamma = p.new_zeros((B, T, P))
    for t in range(T - 1, -1, -1):
        scale = torch.exp((F[t] + G) - log_z)[:, None]
        acc = p.new_zeros((B, P))
        for r in range(int(qcnt.max())):
            e = qslot[(qoff[:-1] + r).clamp(max=qslot.shape[0] - 1)]
            term = _fma(ah[t][:, e] * bh[:, e % S], scale, acc)
            acc = torch.where(qcnt > r, term, acc)
        gamma[:, t] = acc
        if t == 0:
            break
        w = torch.zeros_like(ah[t])
        e = torch.arange(w.shape[-1])[live]
        w[:, live] = p[t][:, pdf[live]] * bh[:, e % S]
        v = _walk(g.csr_offsets, g.csr_cols, g.csr_vals, w)
        mx = v.max(-1).values
        if leaky > 0.0:
            add = leaky * _tree(_shares(v, N, g.init))
            d = mx + add
            v = v + add[:, None]
        else:
            d = mx
        d = torch.where(d > 0, d, torch.ones_like(d))
        bh = v / d[:, None]
        G = (G + ymax[t]) + torch.log(d)
    return gamma


#: K1's and K2's tolerances against their plain versions (as chip_smoke.py
#: holds the kernels on the card): (atol, rtol)
TOL = dict(logc=(1e-5, 0.0), ah=(1e-6, 1e-4), gamma=(1e-5, 1e-4))


def _close(what, got, want):
    atol, rtol = TOL[what]
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=rtol,
                               err_msg=what)


def _residuals(y, leaky):
    """p, ymax [T, B] of y [B, T, P], as den_forward makes them."""
    yt = torch.as_tensor(y).transpose(0, 1)
    ymax = yt.max(-1).values.contiguous()
    return torch.exp(yt - ymax[..., None]).contiguous(), ymax


def _emulate_and_plain(tg, y, leaky):
    """The emulated kernels and the plain versions on y: the forwards on
    p, the backwards on the plain forward's residuals; plus the emulation
    end to end (its own forward's residuals)."""
    p, ymax = _residuals(y, leaky)
    logc_e, ah_e = emulate_forward(p, tg, leaky)
    logc_p, ah_p = tdr.den_forward_plain(p, tg, leaky)
    extra = math.log1p(leaky) if leaky > 0.0 else 0.0

    def back(logc, ah, fn):
        log_z = logc.sum(0) + ymax.sum(0) + extra
        return fn(p, ah, torch.cumsum(logc + ymax, 0), ymax, log_z, tg, leaky)

    return dict(
        logc=(logc_e, logc_p), ah=(ah_e, ah_p),
        gamma=(back(logc_p, ah_p, emulate_backward), back(logc_p, ah_p, tdr.den_backward_plain)),
        end_to_end=(logc_e, ah_e, back(logc_e, ah_e, emulate_backward)),
    )


@pytest.mark.parametrize("leaky", [0.0, 0.1])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_kernel_order_matches_plain_and_jax(name, leaky):
    """The kernels' sums, emulated in their order over the compressed
    forms, against the plain versions and the JAX package's Pallas kernels
    (interpret mode), within K1's and K2's tolerances."""
    kw = GRAPHS[name]
    tg = tdr.DeviceResidentDenGraph.from_host(_graph(tgraphs, **kw), pad_to=8, device="cpu")
    jg = jdr.DeviceResidentDenGraph.from_host(_graph(jgraphs, **kw), pad_to=8, dtype=jnp.float32)
    y = np.random.default_rng(4).normal(size=(3, 7, tg.num_pdfs)).astype(np.float32)
    out = _emulate_and_plain(tg, y, leaky)
    for what in ("logc", "ah", "gamma"):
        _close(what, *out[what])
    _, res_j = jdr.den_forward(jnp.asarray(y), jg, leaky)
    gamma_j = jdr.den_backward(jg, res_j, leaky)
    logc_e, ah_e, gamma_e = out["end_to_end"]
    _close("logc", logc_e, res_j["logc"])
    _close("ah", ah_e, res_j["ah"])
    _close("gamma", gamma_e, gamma_j)


@pytest.mark.parametrize("leaky", [0.0, 0.1])
def test_kernel_order_matches_plain_at_the_bench_graph(bench_trigram, leaky):
    """The same at the bench's trigram graph (K*S = 4352 slots: four or five
    columns per thread, so the per-thread shares and both butterflies of the
    block sums carry real terms), against the plain versions."""
    tg = tdr.DeviceResidentDenGraph.from_host(bench_trigram, device="cpu")
    y = np.random.default_rng(5).normal(size=(2, 4, tg.num_pdfs)).astype(np.float32)
    out = _emulate_and_plain(tg, y, leaky)
    for what in ("logc", "ah", "gamma"):
        _close(what, *out[what])
