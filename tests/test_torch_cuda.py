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

import chip_smoke
import torchain_tpu_torch.data as tdata
import torchain_tpu_torch.graphs as tgraphs
from torchain_tpu_torch.ops import DeviceSupervision, auto_den_graph
from torchain_tpu_torch.ops import attention as at
from torchain_tpu_torch.ops import den_resident as dr
from torchain_tpu_torch.ops import fused_ffn as ff
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


@pytest.mark.parametrize(
    "B,T,W,P", [(5, 9, 16, 80), (3, 11, 16, 83), (4, 7, 16, 1680), (2, 13, 5, 83)],
    ids=["trigram_P", "odd_P", "production_P", "odd_W"],
)
def test_vocab_kernels_match_plain_at_the_edges(dev, B, T, W, P):
    """K5 and K6 bit for bit against their plain versions on chip_smoke.py's
    vocabulary case (rows starting at pdf 0 beside pads, rows ending at pdf
    P-1, a row of pads alone), at row counts B*T that are not a multiple of
    K5's 16-row tile and T not a multiple of K6's 8-frame tile, at P whose
    rows are not 16-byte aligned.  Each call launches once."""
    rng = np.random.default_rng(P + W)
    vocab, gsm = chip_smoke.vocab_case(rng, B, T, W, P, dev)
    y = torch.as_tensor(rng.normal(size=(B, T, P)), dtype=torch.float32, device=dev)
    n5, n6 = ns.vocab_gather.launches, ns.vocab_scatter.launches
    ys = ns.vocab_gather(y, vocab)
    assert ns.vocab_gather.launches == n5 + 1
    gamma = ns.vocab_scatter(gsm, vocab, P)
    assert ns.vocab_scatter.launches == n6 + 1
    torch.cuda.synchronize()
    assert torch.equal(ys, ns.vocab_gather_plain(y, vocab))
    assert torch.equal(gamma, ns.vocab_scatter_plain(gsm, vocab, P))
    assert (gamma[0, 0] == 0).all() and (gamma[2::3, :, P - 1] > 0).all()


def test_vocab_kernels_raise_on_wrong_input(setup):
    den, sup, y = setup
    vocab, P = sup.frame_vocab, den.num_pdfs
    gsm = torch.zeros(vocab.shape[1], vocab.shape[0], vocab.shape[2], device=y.device)
    with pytest.raises(TypeError):
        ns.vocab_gather(y, vocab.long())
    with pytest.raises(TypeError):
        ns.vocab_gather(y, vocab.cpu())
    with pytest.raises(ValueError):
        ns.vocab_gather(y, vocab[:, :-1])
    with pytest.raises(TypeError):
        ns.vocab_gather(y.double(), vocab)
    with pytest.raises(ValueError):
        ns.vocab_scatter(gsm[..., :-1].contiguous(), vocab, P)
    with pytest.raises(ValueError):
        ns.vocab_scatter(gsm, vocab.transpose(0, 1), P)


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


# ---------------------------------------------------------------------------
# K7f / K7b: relative-position attention
# ---------------------------------------------------------------------------

DTYPES = [torch.float32, torch.bfloat16]


def _attn_case(dev, B, T, H, dh, dtype, seed=0):
    rng = np.random.default_rng(seed)
    qkv = torch.as_tensor(rng.normal(size=(B, T, 3 * H * dh)), dtype=torch.float32, device=dev)
    bias = torch.as_tensor(rng.normal(size=(H, T, T)) * 0.3, dtype=torch.float32, device=dev)
    g = torch.as_tensor(rng.normal(size=(B, T, H * dh)), dtype=torch.float32, device=dev)
    return qkv.to(dtype), bias, g.to(dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=["float32", "bfloat16"])
@pytest.mark.parametrize(
    "B,T,H,dh", [(3, 17, 4, 16), (2, 23, 2, 32), (5, 50, 4, 64), (1, 1, 1, 8), (2, 33, 3, 24)],
    ids=["T17", "T23", "main_path_heads", "one_frame", "three_heads"],
)
def test_attention_kernels_match_plain(dev, B, T, H, dh, dtype):
    qkv, bias, g = _attn_case(dev, B, T, H, dh, dtype)
    scale = 1.0 / math.sqrt(dh)
    n_f, n_b = at.attention_forward.launches, at.attention_backward.launches
    out = at.attention_forward(qkv, bias, H, scale)
    dqkv, dbias = at.attention_backward(qkv, bias, g, H, scale)
    torch.cuda.synchronize()
    assert (at.attention_forward.launches, at.attention_backward.launches) == (n_f + 1, n_b + 1)
    out_p = at.attention_forward_plain(qkv, bias, H, scale)
    dqkv_p, dbias_p = at.attention_backward_plain(qkv, bias, g, H, scale)
    assert out.dtype == dqkv.dtype == dtype and dbias.dtype == torch.float32
    # float32 sums of dh and T terms in another order; bfloat16 outputs may
    # sit one rounding step apart (2^-8 relative)
    tol = dict(atol=2e-5, rtol=1e-5) if dtype == torch.float32 else dict(atol=2e-2, rtol=1e-2)
    torch.testing.assert_close(out, out_p, **tol)
    torch.testing.assert_close(dqkv, dqkv_p, **tol)
    # dbias is float32 whatever qkv is: B slices added in batch order
    torch.testing.assert_close(dbias, dbias_p, atol=5e-5, rtol=1e-4)
    # the same kernels twice give the same bits (no atomics)
    assert torch.equal(at.attention_forward(qkv, bias, H, scale), out)
    again = at.attention_backward(qkv, bias, g, H, scale)
    assert torch.equal(again[0], dqkv) and torch.equal(again[1], dbias)


def test_attention_function_on_card_matches_cpu(dev):
    qkv, bias, g = _attn_case(dev, 3, 19, 2, 16, torch.float32, seed=1)
    grads = {}
    for d in ("cuda", "cpu"):
        q, b = (t.detach().to(d).clone().requires_grad_() for t in (qkv, bias))
        out = at.fused_relpos_attention(q, b, 2, 0.25)
        torch.sum(out * g.to(d)).backward()
        grads[d] = (out.detach().cpu(), q.grad.cpu(), b.grad.cpu())
    for a, b in zip(grads["cuda"], grads["cpu"]):
        torch.testing.assert_close(a, b, atol=5e-5, rtol=1e-4)


def test_attention_kernels_raise_on_wrong_input(dev):
    qkv, bias, g = _attn_case(dev, 2, 9, 2, 8, torch.float32)
    with pytest.raises(TypeError):
        at.attention_forward(qkv.double(), bias, 2, 0.3)
    with pytest.raises(TypeError):
        at.attention_forward(qkv, bias.half(), 2, 0.3)
    with pytest.raises(ValueError):
        at.attention_forward(qkv, bias[:, :, :-1].contiguous(), 2, 0.3)
    with pytest.raises(ValueError):
        at.attention_forward(qkv[:, :, :-1], bias, 2, 0.3)
    with pytest.raises(TypeError):  # g in another dtype than qkv
        at.attention_backward(qkv, bias, g.bfloat16(), 2, 0.3)
    with pytest.raises(ValueError):
        at.attention_backward(qkv, bias, g[:, :-1].contiguous(), 2, 0.3)


@pytest.mark.parametrize("dtype", DTYPES, ids=["float32", "bfloat16"])
def test_attention_forward_runs_beyond_the_backward_limit(dev, dtype):
    """At dh 64 the forward's block fits up to T=162, the backward's up to
    T=117: at T=150 K7f runs (within chip_smoke.py's K7f tolerances) and
    K7b raises."""
    B, T, H, dh = 2, 150, 4, 64
    qkv, bias, g = _attn_case(dev, B, T, H, dh, dtype, seed=3)
    scale = 1.0 / math.sqrt(dh)
    n = at.attention_forward.launches
    out = at.attention_forward(qkv, bias, H, scale)
    torch.cuda.synchronize()
    assert at.attention_forward.launches == n + 1
    tol = dict(atol=5e-5, rtol=1e-5) if dtype == torch.float32 else dict(atol=2e-2, rtol=1e-2)
    torch.testing.assert_close(out, at.attention_forward_plain(qkv, bias, H, scale), **tol)
    n = at.attention_backward.launches
    with pytest.raises(ValueError, match="shared memory"):
        at.attention_backward(qkv, bias, g, H, scale)
    assert at.attention_backward.launches == n


def test_attention_beyond_the_shared_memory_limit_raises(dev):
    """T * dh and T * T must fit one block's shared memory; beyond that the
    wrappers raise, they do not fall back."""
    T, H, dh = 400, 1, 64
    qkv = torch.zeros(1, T, 3 * H * dh, device=dev)
    bias = torch.zeros(H, T, T, device=dev)
    n = at.attention_forward.launches
    with pytest.raises(ValueError, match="shared memory"):
        at.attention_forward(qkv, bias, H, 0.1)
    with pytest.raises(ValueError, match="shared memory"):
        at.attention_backward(qkv, bias, torch.zeros(1, T, H * dh, device=dev), H, 0.1)
    assert at.attention_forward.launches == n


# ---------------------------------------------------------------------------
# K10f / K10b: fused feed-forward
# ---------------------------------------------------------------------------


def _ffn_case(dev, N, D, F, dtype, seed=0, init=False):
    """Operands from a seed: weights of scale 0.3, or with `init` of their
    initialiser's scale (variance 1 / fan-in) as the conformer starts."""
    rng = np.random.default_rng(seed)
    r = lambda *s: torch.as_tensor(rng.standard_normal(s), dtype=torch.float32, device=dev)  # noqa: E731
    xn, res, g = r(N, D).to(dtype), r(N, D).to(dtype), r(N, D).to(dtype)
    s1, s2 = (D ** -0.5, F ** -0.5) if init else (0.3, 0.3)
    w1, w2 = (r(D, F) * s1).to(dtype), (r(F, D) * s2).to(dtype)
    return xn, res, w1, r(F) * 0.1, w2, r(D) * 0.1, g


@pytest.mark.parametrize("dtype", DTYPES, ids=["float32", "bfloat16"])
@pytest.mark.parametrize(
    "N,D,F,init",
    [(48, 128, 256, False), (1040, 128, 256, False), (37, 96, 192, False), (5, 24, 56, False),
     (70, 300, 130, False), (6400, 256, 1024, True), (1000, 256, 200, True)],
    ids=["aligned", "many_rows", "non_aligned", "tiny", "wide_rows", "conformer",
         "ragged_rows_and_chunk"],
)
def test_ffn_kernels_match_plain(dev, N, D, F, init, dtype):
    # the conformer's shape (and rows and F that are no multiple of the
    # kernels' 64-row tile and 128-column chunk) with the conformer's weight
    # scale: at 0.3, float32 weight gradients over 1000 and more rows reach
    # ~100, and the float32 rounding of such sums in any order (the plain
    # version's cuBLAS sums and an FMA loop's alike) sits at the 1e-4
    # tolerance
    xn, res, w1, b1, w2, b2, g = _ffn_case(dev, N, D, F, dtype, init=init)
    n_f, n_b = ff.ffn_forward.launches, ff.ffn_backward.launches
    out = ff.ffn_forward(xn, res, w1, b1, w2, b2, 0.5)
    grads = ff.ffn_backward(xn, g, w1, b1, w2, 0.5)
    torch.cuda.synchronize()
    assert (ff.ffn_forward.launches, ff.ffn_backward.launches) == (n_f + 1, n_b + 1)
    out_p = ff.ffn_forward_plain(xn, res, w1, b1, w2, b2, 0.5)
    grads_p = ff.ffn_backward_plain(xn, g, w1, b1, w2, 0.5)
    assert out.dtype == grads[0].dtype == dtype
    assert all(t.dtype == torch.float32 for t in grads[1:])
    # float32: sums of D, F or N terms in another order.  bfloat16: out and dx
    # may sit a rounding step apart; a hidden activation on a rounding
    # boundary moves a weight-gradient sum by one bfloat16 step of one term
    if dtype == torch.float32:
        tol = [dict(atol=1e-4, rtol=1e-4)] * 6
    else:
        tol = [dict(atol=3e-2, rtol=2e-2)] * 2 + [dict(atol=2e-2, rtol=1e-2)] * 4
    for got, want, kw, name in zip((out, *grads), (out_p, *grads_p), tol,
                                   ("out", "dx", "dw1", "db1", "dw2", "db2")):
        torch.testing.assert_close(got, want, **kw, msg=lambda m, name=name: f"{name}: {m}")
    # the same kernels twice give the same bits (no atomics)
    assert torch.equal(ff.ffn_forward(xn, res, w1, b1, w2, b2, 0.5), out)
    for a, b in zip(ff.ffn_backward(xn, g, w1, b1, w2, 0.5), grads):
        assert torch.equal(a, b)


def test_ffn_apply_on_card_matches_cpu(dev):
    xn, res, w1, b1, w2, b2, g = _ffn_case(dev, 2 * 13, 40, 72, torch.float32, seed=1)
    grads = {}
    for d in ("cuda", "cpu"):
        args = [t.to(d).reshape(2, 13, 40).clone().requires_grad_() for t in (xn, res)]
        args += [t.to(d).clone().requires_grad_() for t in (w1, b1, w2, b2)]
        out = ff.ffn_apply(*args)
        torch.sum(out * g.to(d).reshape(2, 13, 40)).backward()
        grads[d] = [out.detach().cpu()] + [a.grad.cpu() for a in args]
    for a, b in zip(grads["cuda"], grads["cpu"]):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


def test_ffn_kernels_raise_on_wrong_input(dev):
    xn, res, w1, b1, w2, b2, g = _ffn_case(dev, 12, 16, 32, torch.float32)
    with pytest.raises(TypeError):
        ff.ffn_forward(xn.double(), res.double(), w1, b1, w2, b2, 0.5)
    with pytest.raises(TypeError):  # weights must already be in the trunk dtype
        ff.ffn_forward(xn.bfloat16(), res.bfloat16(), w1, b1, w2, b2, 0.5)
    with pytest.raises(TypeError):
        ff.ffn_forward(xn, res, w1, b1.double(), w2, b2, 0.5)
    with pytest.raises(ValueError):
        ff.ffn_forward(xn, res, w1, b1, w2.t().contiguous(), b2, 0.5)
    with pytest.raises(ValueError):
        ff.ffn_backward(xn, g[:-1], w1, b1, w2, 0.5)
    with pytest.raises(ValueError, match="shared memory"):  # a row tile too wide for one block
        D = ff.MAX_D + 1
        ff.ffn_forward(torch.zeros(4, D, device=dev), torch.zeros(4, D, device=dev),
                       torch.zeros(D, 8, device=dev), torch.zeros(8, device=dev),
                       torch.zeros(8, D, device=dev), torch.zeros(D, device=dev), 0.5)


@pytest.mark.parametrize("ffn_impl", ["dense", "fused"])
def test_conformer_on_card_matches_cpu(dev, ffn_impl):
    """A small float32 conformer through K7f/K7b (and K10f/K10b) on the card
    against the plain versions on the CPU, from the same weights."""
    import copy

    from torchain_tpu_torch.models import Conformer, ConformerConfig

    cfg = ConformerConfig(num_pdfs=11, dim=32, num_layers=2, num_heads=2, prefinal_dim=16,
                          ffn_impl=ffn_impl)
    model = Conformer(cfg, 8, device="cpu", generator=torch.Generator().manual_seed(0))
    feats = torch.randn(3, 7 * 3 + 4, 8, generator=torch.Generator().manual_seed(1))
    n7, n10 = at.attention_backward.launches, ff.ffn_backward.launches
    out = {}
    for d in ("cuda", "cpu"):
        m = copy.deepcopy(model).to(d)
        c, x = m(feats.to(d), train=True)
        (c.square().sum() + x.sum()).backward()
        out[d] = [c.detach().cpu()] + [p.grad.cpu() for p in m.parameters()]
    assert at.attention_backward.launches == n7 + 2
    assert ff.ffn_backward.launches == n10 + (4 if ffn_impl == "fused" else 0)
    for a, b in zip(out["cuda"], out["cpu"]):
        torch.testing.assert_close(a, b, atol=1e-4 * max(1.0, float(b.abs().max())), rtol=1e-3)


# ---------------------------------------------------------------------------
# K8f / K8b: the flat-start numerator recursions
# ---------------------------------------------------------------------------


def _e2e_case(dev, B, T, S, K, seed, holes=False):
    """Random cyclic tables with odd sizes: left-packed rows (or, with
    `holes`, live slots anywhere in a row), a self-loop on every state so
    that mass survives, states without arcs, sequence 1 (where there is
    one) without a final state."""
    rng = np.random.default_rng(seed)
    if holes:
        pad = rng.random(size=(B, S, K)) < 0.6
    else:
        pad = np.arange(K) >= rng.integers(0, K + 1, size=(B, S, 1))
    src = np.where(pad, -1, rng.integers(0, S, size=(B, S, K)))
    src[:, :, 0] = np.arange(S)  # self-loops
    src[:, S - 1, :] = -1  # a state without arcs
    logw = np.where(src < 0, -np.inf, rng.normal(size=(B, S, K))).astype(np.float32)
    t = lambda a, dt: torch.as_tensor(a, dtype=dt, device=dev)  # noqa: E731
    ylocal = t(rng.normal(size=(B, T, S, K)), torch.float32)
    final = t(np.where(rng.random(size=(B, S)) < 0.5, -np.inf, 0.0), torch.float32)
    final[:, 0] = 0.0
    if B > 1:
        final[1] = -np.inf
    return ylocal, t(src, torch.int64), t(logw, torch.float32), final


@pytest.mark.parametrize("placed", [False, True], ids=["live_tables", "placed_tables"])
@pytest.mark.parametrize(
    "B,T,S,K,holes",
    [(5, 9, 7, 3, False), (3, 1, 5, 1, False), (2, 12, 70, 37, True), (2, 3, 300, 120, False)],
    ids=["odd_sizes", "one_frame", "holes_and_wide_rows", "tables_beyond_shared_memory"],
    # the last: 8 bytes a slot, more than a block's shared memory holds; the
    # kernels read the tables from device memory, so no S * K is too large
)
def test_e2e_kernels_match_plain(dev, B, T, S, K, holes, placed):
    ylocal, src, logw, final = _e2e_case(dev, B, T, S, K, seed=S, holes=holes)
    pre = nr.e2e_kernel_tables(src, logw) if placed else None
    n_f, n_b = nr.e2e_forward_resident.launches, nr.e2e_backward_resident.launches
    rest_k = nr.e2e_forward_resident(ylocal, src, logw, pre=pre)
    torch.cuda.synchronize()
    rest_p = nr.e2e_forward_plain(ylocal, src, logw)
    _close_where_finite(rest_k, rest_p)
    assert torch.isneginf(rest_k[:, :, S - 1]).all()  # the state without arcs
    assert torch.equal(nr.e2e_forward_resident(ylocal, src, logw, pre=pre), rest_k)

    log_p = torch.logsumexp(rest_p[-1] + final, dim=-1)
    if B > 1:
        assert torch.isneginf(log_p[1])
    if B > 2:
        log_p[2] = math.nan
    a0 = torch.full((1, B, S), -math.inf, device=dev)
    a0[:, :, 0] = 0.0
    alphas = torch.cat([a0, rest_p[:-1]])
    args = (ylocal, alphas, src, logw, final, log_p)
    post_k = nr.e2e_backward_resident(*args, pre=pre)
    torch.cuda.synchronize()
    post_p = nr.e2e_backward_plain(*args)
    assert torch.isfinite(post_k).all()
    torch.testing.assert_close(post_k, post_p, atol=1e-5, rtol=1e-4)
    assert (post_k[(src < 0)[:, None].expand_as(post_k)] == 0).all()
    if B > 1:
        assert (post_k[1] == 0).all()
    if B > 2:
        assert (post_k[2] == 0).all()
    assert torch.equal(nr.e2e_backward_resident(*args, pre=pre), post_k)
    assert (nr.e2e_forward_resident.launches, nr.e2e_backward_resident.launches) == (
        n_f + 2, n_b + 2)


def test_e2e_kernels_raise_on_wrong_dtype_and_shape(dev):
    ylocal, src, logw, final = _e2e_case(dev, 2, 4, 5, 3, seed=0)
    with pytest.raises(TypeError):
        nr.e2e_forward_resident(ylocal.double(), src, logw)
    with pytest.raises(ValueError):
        nr.e2e_forward_resident(ylocal, src[:, :4], logw[:, :4])
    alphas = torch.zeros(4, 2, 5, device=dev)
    log_p = torch.zeros(2, device=dev)
    with pytest.raises(ValueError):
        nr.e2e_backward_resident(ylocal, alphas[:3], src, logw, final, log_p)
    with pytest.raises(TypeError):
        nr.e2e_backward_resident(ylocal, alphas, src, logw, final, log_p.double())
    with pytest.raises(ValueError, match="contiguous"):
        nr.e2e_forward_resident(ylocal.transpose(2, 3).contiguous().transpose(2, 3), src, logw)


def test_e2e_path_on_the_card_matches_the_cpu(dev):
    """ops/num_e2e.py end to end: card (K8f, K8b) against CPU (plain)."""
    from torchain_tpu_torch.ops import DeviceE2eSupervision
    from torchain_tpu_torch.ops import num_e2e as ne

    c = tdata.synthetic_dataset(num_utts=10, num_phones=8, feat_dim=8, utt_frames_out=(12, 16),
                                seed=3, lm_order=3, lm_extra_states=40)
    ds = tdata.E2eChainDataset(c.utts, c.tree, c.norm_fst, chunk_frames_out=12,
                               left_context=3, right_context=3)
    host = next(ds.batches(4, shuffle=False)).sup
    y = torch.as_tensor(np.random.default_rng(5).normal(size=(4, 12, c.tree.num_pdfs)),
                        dtype=torch.float32)
    out = {}
    for d in ("cpu", dev):
        sup = DeviceE2eSupervision.from_host(host, device=d).with_kernel_tables()
        lp, al = ne.e2e_forward(y.to(d), sup)
        out[str(d)] = (lp.cpu(), ne.e2e_backward(y.to(d), sup, lp, al).cpu())
    (lp_c, g_c), (lp_k, g_k) = out["cpu"], out[str(dev)]
    torch.testing.assert_close(lp_k, lp_c, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(g_k, g_c, atol=1e-5, rtol=1e-4)


# ---------------------------------------------------------------------------
# K9f / K9b: the fused dense Moore denominator
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def dense_graph(dev):
    from torchain_tpu_torch.ops import DeviceDenseDenGraph

    c = tdata.synthetic_dataset(num_utts=12, num_phones=6, feat_dim=8,
                                utt_frames_out=(9, 12), seed=1, lm_order=3,
                                lm_extra_states=50, context_width=2)
    # pad_to 24: odd tile edges, and padded expanded states
    dense = tgraphs.make_dense_den_graph(c.den_graph, pad_to=24)
    g = DeviceDenseDenGraph.from_host(dense, device=dev, fused=True)
    assert g.real_exp < g.num_exp
    return g


@pytest.mark.parametrize("leaky", [0.0, 0.1])
@pytest.mark.parametrize("B,T", [(5, 9), (3, 1), (70, 4)],
                         ids=["odd_sizes", "one_frame", "more_rows_than_a_tile"])
def test_dense_den_kernels_match_plain_and_den_dense(dev, dense_graph, leaky, B, T):
    from torchain_tpu_torch.ops import den_dense as dd
    from torchain_tpu_torch.ops import den_pallas as dp

    g = dense_graph
    y = torch.as_tensor(np.random.default_rng(B).normal(size=(B, T, g.num_pdfs)),
                        dtype=torch.float32, device=dev)
    n = (dp.dense_forward_kernel.launches, dp.dense_backward_kernel.launches)
    log_z, res = dp.den_forward(y, g, leaky)
    gamma = dp.den_backward(g, res, leaky)
    torch.cuda.synchronize()
    assert (dp.dense_forward_kernel.launches, dp.dense_backward_kernel.launches) == (
        n[0] + 1, n[1] + 1)
    logc_p, sig_p = dp.dense_forward_plain(res["pe"], g, leaky)
    # float32 sums in another order: 1e-5 on values of order 1
    torch.testing.assert_close(res["logc"], logc_p, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(res["sigma_hats"], sig_p, atol=1e-6, rtol=1e-4)
    ymax_t = res["ymax"].T.contiguous()
    F = torch.cumsum(logc_p + ymax_t, 0)
    fscale = torch.cat([F.new_zeros((1, B)), F[:-1]]) + ymax_t - res["log_z"]
    args = (res["pe"], g, sig_p, fscale, ymax_t, leaky)
    gout_k = dp.dense_backward_kernel(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(gout_k, dp.dense_backward_plain(*args), atol=1e-6, rtol=1e-4)
    assert (gout_k[..., g.real_exp:] == 0).all()
    torch.testing.assert_close(gout_k.sum(-1), torch.ones(T, B, device=dev), atol=1e-4, rtol=0)
    # the same kernel twice gives the same bits (no atomics)
    assert torch.equal(dp.dense_backward_kernel(*args), gout_k)
    # and the fused recursion agrees with the matrix-product one
    log_z_d, res_d = dd.den_forward(y, g, leaky)
    torch.testing.assert_close(log_z, log_z_d, atol=1e-4, rtol=1e-5)
    torch.testing.assert_close(gamma, dd.den_backward(g, res_d, leaky), atol=1e-5, rtol=1e-4)


def test_dense_den_kernels_raise_on_wrong_dtype_and_shape(dev, dense_graph):
    from torchain_tpu_torch.ops import den_pallas as dp

    g = dense_graph
    pe = torch.rand(3, 2, g.num_exp, device=dev)
    with pytest.raises(TypeError):
        dp.dense_forward_kernel(pe.double(), g, 0.1)
    with pytest.raises(ValueError):
        dp.dense_forward_kernel(pe[..., :-1].contiguous(), g, 0.1)
    sig = torch.rand(3, 2, g.num_orig, device=dev)
    with pytest.raises(ValueError):
        dp.dense_backward_kernel(pe, g, sig[:2], torch.zeros(3, 2, device=dev),
                                 torch.zeros(3, 2, device=dev), 0.1)


# ---------------------------------------------------------------------------
# T1: the shared-memory probe
# ---------------------------------------------------------------------------


def test_probe_smem_finds_the_device_limit(dev):
    from torchain_tpu_torch import kernels
    from torchain_tpu_torch.tools import probe_smem as ps

    limit = kernels.library("probe_smem").probe_smem_limit() // 1024
    lines = []
    best = ps.largest([16, 48, 100, limit, limit + 1, limit + 64], log=lines.append)
    assert best == limit
    assert sum("PASS" in line for line in lines) == 4 and "FAIL" in lines[-1]
    x = torch.arange(128, dtype=torch.float32, device=dev)
    assert torch.equal(ps.try_size(x, limit), ps.try_size_plain(x))
    with pytest.raises(RuntimeError):
        ps.try_size(x, limit + 1)
    # a refused size leaves the device usable
    assert torch.equal(ps.try_size(x, 64), 5.0 * x)
    with pytest.raises(TypeError):
        ps.try_size(x.double(), 64)
