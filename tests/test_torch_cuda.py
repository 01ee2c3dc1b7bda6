"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  These need an NVIDIA GPU and nvcc (they build the kernels); without
a card they skip.  Run them on the GPU machine with

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest

(`--noconftest`: tests/conftest.py configures JAX, which that machine
lacks.)

Graphs and batches are small; chip_smoke.py repeats the comparison at the
main path's shapes."""

import dataclasses
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


def _synthetic_den(rng, S, P, per_col, dev, dead=0.05):
    """A slot-dense graph (K=2) with `per_col` random predecessors per live
    slot, rows normalised like transition probabilities, a share `dead` of
    the slots dead; real states S."""
    KS = 2 * S
    live = rng.random(KS) >= dead
    V = np.zeros((S, KS), np.float32)
    for e in np.flatnonzero(live):
        V[rng.choice(S, size=per_col, replace=False), e] = rng.random(per_col) + 0.1
    V /= np.maximum(V.sum(1, keepdims=True), 1e-30)
    slot_pdf = np.where(live, rng.integers(0, P, size=KS), -1).astype(np.int32)
    init = rng.random(S).astype(np.float32)
    return dr.DeviceResidentDenGraph.from_dense(V, slot_pdf, init / init.sum(), P, S, device=dev)


@pytest.fixture(scope="module")
def den_graphs(dev):
    """The small trigram-biphone graph of `setup`; the same host graph with
    one slot per state (so states are split into clones); and a synthetic
    graph whose compressed V (81,920 non-zeros) does not fit shared memory,
    so the kernels read it through L2."""
    c = tdata.synthetic_dataset(num_utts=12, num_phones=6, feat_dim=8,
                                utt_frames_out=(9, 12), seed=1, lm_order=3,
                                lm_extra_states=50, context_width=2)
    clones = dr.DeviceResidentDenGraph.from_host(c.den_graph, pad_to=32, max_slots=1, device=dev)
    assert clones.num_states > clones.real_states
    return dict(
        small=auto_den_graph(c.den_graph, pad_to=32, device=dev),
        clones=clones,
        l2=_synthetic_den(np.random.default_rng(3), 1024, 50, 40, dev),
    )


@pytest.mark.parametrize("leaky", [0.0, 0.1])
@pytest.mark.parametrize("B,T", [(5, 9), (5, 1), (128, 50)], ids=["B5T9", "B5T1", "B128T50"])
@pytest.mark.parametrize("graph", ["small", "clones", "l2"])
def test_den_kernels_match_plain(den_graphs, graph, B, T, leaky):
    """K1 and K2 against their plain versions (the dense V): the same
    non-finite entries, K1's and K2's tolerances, one launch a call, and two
    launches on the same inputs give the same bits."""
    den = den_graphs[graph]
    dev = den.V.device
    assert [dr.shared_plan(den, d, dev)[1] for d in (0, 1)] == ([0, 0] if graph == "l2" else [1, 1])
    y = torch.as_tensor(np.random.default_rng(B + T).normal(size=(B, T, den.num_pdfs)),
                        dtype=torch.float32, device=dev)
    yt = y.transpose(0, 1)
    ymax = yt.max(-1).values.contiguous()
    p = torch.exp(yt - ymax[..., None]).contiguous()
    n = dr.den_forward_kernel.launches
    logc_k, ah_k = dr.den_forward_kernel(p, den, leaky)
    torch.cuda.synchronize()
    assert dr.den_forward_kernel.launches == n + 1
    logc_p, ah_p = dr.den_forward_plain(p, den, leaky)
    # float32 sums in another order: 1e-5 on values of order 1; ah sums to
    # one over a frame's slots
    _close_where_finite(logc_k, logc_p, atol=1e-5, rtol=0.0)
    _close_where_finite(ah_k, ah_p, atol=1e-6, rtol=1e-4)
    again = dr.den_forward_kernel(p, den, leaky)
    assert torch.equal(again[0], logc_k) and torch.equal(again[1], ah_k)

    log_z = (logc_p.sum(0) + ymax.sum(0) + (math.log1p(leaky) if leaky else 0.0)).contiguous()
    F = torch.cumsum(logc_p + ymax, 0).contiguous()
    args = (p, ah_p, F, ymax, log_z, den, leaky)
    n = dr.den_backward_kernel.launches
    g_k = dr.den_backward_kernel(*args)
    torch.cuda.synchronize()
    assert dr.den_backward_kernel.launches == n + 1
    g_p = dr.den_backward_plain(*args)
    _close_where_finite(g_k, g_p, atol=1e-5, rtol=1e-4)
    # the same kernel twice gives the same bits (no atomics)
    assert torch.equal(dr.den_backward_kernel(*args), g_k)


def test_host_copy_of_the_carried_state_equals_the_library(dev):
    """ops/den_resident.py `carried_bytes` (what the CPU holds the resident
    form to) against csrc/den_resident.cu `den_shared_bytes` over a sweep of
    (S_pad, K, P), and the H100's limit against the card's where it is one."""
    from torchain_tpu_torch import kernels

    need = kernels.entry("den_resident", "den_shared_bytes")
    for S in (8, 128, 2176, 3968, 11520, 11648, 32640):
        for K in (1, 2, 3):
            for P in (1, 80, 83, 1680, 60000):
                for bwd in (0, 1):
                    assert dr.carried_bytes(bwd, S, K, P) == need(bwd, S, K, P, 0, 0, 0)
    if "H100" in torch.cuda.get_device_name(0):
        assert kernels.entry("den_resident", "den_shared_limit")() == dr.H100_SHARED_LIMIT


def test_den_kernels_refuse_a_carried_state_beyond_shared_memory(dev):
    """A graph whose carried state (here p rows of 60,000 pdfs: 240,000
    bytes each) exceeds a block's shared memory raises before any launch;
    nothing falls back."""
    den = _synthetic_den(np.random.default_rng(4), 64, 60000, 3, dev)
    p = torch.rand(2, 3, 60000, device=dev)
    n = (dr.den_forward_kernel.launches, dr.den_backward_kernel.launches)
    with pytest.raises(ValueError, match="carried state"):
        dr.den_forward_kernel(p, den, 0.1)
    z = torch.zeros(2, 3, device=dev)
    with pytest.raises(ValueError, match="carried state"):
        dr.den_backward_kernel(p, torch.zeros(2, 3, 128, device=dev), z, z, z[0], den, 0.1)
    assert (dr.den_forward_kernel.launches, dr.den_backward_kernel.launches) == n


def test_den_kernels_raise_on_wrong_dtype(setup):
    den, _, y = setup
    p = torch.exp(y.transpose(0, 1)).contiguous()
    with pytest.raises(TypeError):
        dr.den_forward_kernel(p.double(), den, 0.1)
    with pytest.raises(TypeError):
        dr.den_forward_kernel(p, dataclasses.replace(den, csc_vals=den.csc_vals.half()), 0.1)


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


@pytest.mark.parametrize(
    "B,T,S,Kr,W,staged",
    [(3, 12, 20, 12, 16, 1), (3, 30, 12, 4, 16, 1), (2, 150, 40, 8, 16, 0)],
    ids=["more_arcs_than_a_warp", "production_widths", "list_beyond_shared_memory"],
    # the first: trigram widths, about 120 live arcs a frame (over 39 frames:
    # test_steady_backward_over_forty_frames_against_float64); the last:
    # about 380 KB of records a sequence, more than a block's shared memory,
    # so each frame's records are streamed through two buffers
)
def test_steady_backward_plans_match_plain(dev, B, T, S, Kr, W, staged):
    """K4 on each of its shared-memory plans: the plain version's values
    within the tolerances of chip_smoke.py, exact zeros for the impossible
    sequence, two launches bit-equal, and the plan not chosen, where it
    fits, bit-equal too."""
    alpha1, src, lpdf, logw, ysm, final = _steady_case(dev, B, T, S, Kr, W, seed=T)
    pre = nr.kernel_tables(src, lpdf, logw)
    arc_off, arcs, _ = pre
    assert nr.steady_plan(arcs.shape[1], T - 1, S, S * Kr, W, dev)[1] == staged
    if S * Kr > 32:
        assert int((arc_off[:, 1:] - arc_off[:, :-1]).max()) > 32
    aT, rest = nr.steady_forward_plain(alpha1, src, lpdf, logw, ysm)
    alphas = torch.cat([alpha1[None], rest[:-1]])
    log_p = torch.logsumexp(aT + final, dim=-1)
    assert torch.isneginf(log_p[1])
    args = (src, lpdf, logw, ysm, alphas, final, log_p)
    n4 = nr.steady_backward.launches
    beta1_k, gsm_k = nr.steady_backward(*args, pre=pre)
    torch.cuda.synchronize()
    beta1_p, gsm_p = nr.steady_backward_plain(*args)
    _close_where_finite(beta1_k, beta1_p)
    torch.testing.assert_close(gsm_k, gsm_p, atol=1e-6, rtol=1e-5)
    assert (gsm_k[:, 1] == 0).all()
    again = nr.steady_backward(*args, pre=pre)
    assert torch.equal(again[0], beta1_k) and torch.equal(again[1], gsm_k)
    assert nr.steady_backward.launches == n4 + 2
    if staged:
        other = nr.steady_backward(*args, pre=pre, staged=0)
        assert torch.equal(other[0], beta1_k) and torch.equal(other[1], gsm_k)


def _tolerance_share(got, want, atol, rtol) -> float:
    """The largest |got - want| / (atol + rtol |want|) over the entries where
    `want` is finite: 1.0 is the edge of the tolerance."""
    fin = torch.isfinite(want)
    err = (got[fin].double() - want[fin]).abs() / (atol + rtol * want[fin].abs())
    return float(err.max()) if err.numel() else 0.0


def test_steady_backward_over_forty_frames_against_float64(dev):
    """K4 at trigram widths (S 20, Kr 12: about 120 live arcs a frame) over
    39 frames, held against the plain version run in float64: within
    chip_smoke.py's tolerances, and no farther from it than the float32
    plain version, which here misses the kernel by more than gsm's rtol
    (two float32 sum orders erring on opposite sides).  Prints both shares
    of the tolerances and a digest of the kernel's outputs, by which two
    builds of K4 are compared bit for bit (run with -s).  Float64 is no
    yardstick for every case: over 149 frames (the streamed case above),
    where alpha and log p reach about 340, the float32 plain version lies
    up to 6 times gsm's tolerance from it on the CPU, and the kernel up to
    8e-5 relative on an H100, while the two agree within the tolerance."""
    import hashlib

    alpha1, src, lpdf, logw, ysm, final = _steady_case(dev, 3, 40, 20, 12, 16, seed=40)
    aT, rest = nr.steady_forward_plain(alpha1, src, lpdf, logw, ysm)
    args = (src, lpdf, logw, ysm, torch.cat([alpha1[None], rest[:-1]]), final,
            torch.logsumexp(aT + final, dim=-1))
    beta1_k, gsm_k = nr.steady_backward(*args, pre=nr.kernel_tables(src, lpdf, logw))
    beta1_p, gsm_p = nr.steady_backward_plain(*args)
    beta1_d, gsm_d = nr.steady_backward_plain(
        *(x.double() if x.is_floating_point() else x for x in args))
    share = {
        name: (_tolerance_share(k, d, atol, rtol), _tolerance_share(p, d, atol, rtol))
        for name, k, p, d, atol, rtol in (("beta1", beta1_k, beta1_p, beta1_d, 1e-5, 1e-5),
                                          ("gsm", gsm_k, gsm_p, gsm_d, 1e-6, 1e-5))
    }
    digest = hashlib.sha256(beta1_k.cpu().numpy().tobytes() + gsm_k.cpu().numpy().tobytes())
    print(f"K4 over 39 frames, share of the tolerance from float64 (kernel, plain float32):"
          f" {share}; kernel digest {digest.hexdigest()[:16]}")
    _close_where_finite(beta1_k, beta1_d.float())
    torch.testing.assert_close(gsm_k, gsm_d.float(), atol=1e-6, rtol=1e-5)
    assert all(k <= p for k, p in share.values())


def _lower_limit(monkeypatch, dev, k3=None, k8f=None):
    """The shared-memory limit of K3 (sizes `k3`: L, T-1, S, W) and of K8f
    (`k8f`: L, S) lowered to one byte below the staged plan the sizes
    choose, so that the same sizes choose the unstaged plan."""
    limits = {}
    if k3 is not None:
        limits[nr.NUM_LIMIT] = nr.steady_forward_plan(*k3, dev)[0] - 1
    if k8f is not None:
        limits[nr.E2E_LIMIT] = nr.e2e_forward_plan(*k8f, dev)[0] - 1
    real = nr.shared_limit
    monkeypatch.setattr(nr, "shared_limit",
                        lambda entry, device: limits.get(entry) or real(entry, device))
    if k3 is not None:
        assert nr.steady_forward_plan(*k3, dev)[1] == 0
    if k8f is not None:
        assert nr.e2e_forward_plan(*k8f, dev)[1] == 0


@pytest.mark.parametrize(
    "B,T,S,Kr,W,staged",
    [(3, 50, 20, 12, 16, 1), (3, 50, 12, 4, 16, 1), (2, 12, 70, 5, 40, 1),
     (2, 150, 40, 8, 16, 0)],
    ids=["trigram_widths", "production_widths", "more_states_than_a_warp",
         "list_beyond_shared_memory"],
    # S <= 32: one warp a sequence, a frame ends at __syncwarp; S = 70: three
    # warps and a block barrier; the last: about 380 KB of records a
    # sequence, so the list is read from device memory
)
def test_steady_forward_plans_match_plain(dev, monkeypatch, B, T, S, Kr, W, staged):
    """K3 on each of its shared-memory plans: the plain version's values
    within chip_smoke.py's tolerances, two launches bit-equal, and the
    unstaged plan, where the sizes chose the staged one, bit-equal too (the
    limit lowered below the staged plan)."""
    alpha1, src, lpdf, logw, ysm, _ = _steady_case(dev, B, T, S, Kr, W, seed=T + S)
    pre = nr.kernel_tables(src, lpdf, logw)
    sizes = (pre[1].shape[1], T - 1, S, W)
    assert nr.steady_forward_plan(*sizes, dev)[1] == staged
    n3 = nr.steady_forward.launches
    aT_k, rest_k = nr.steady_forward(alpha1, src, lpdf, logw, ysm, pre=pre)
    torch.cuda.synchronize()
    _close_where_finite(rest_k, nr.steady_forward_plain(alpha1, src, lpdf, logw, ysm)[1])
    assert torch.equal(aT_k, rest_k[-1])
    assert torch.equal(nr.steady_forward(alpha1, src, lpdf, logw, ysm, pre=pre)[1], rest_k)
    assert nr.steady_forward.launches == n3 + 2
    if staged:
        _lower_limit(monkeypatch, dev, k3=sizes)
        other = nr.steady_forward(alpha1, src, lpdf, logw, ysm, pre=pre)[1]
        assert torch.equal(other, rest_k)


def test_kernel_digests(dev):
    """Digests of K3's alphas (the trigram and production widths over 49
    frames, and over 39), and of K7f's and K7b's outputs at the main path's
    head width 64 in both dtypes, on inputs from a seed, through calls that
    every build since the first takes: run with -s in two checkouts to
    compare two builds bit for bit."""
    import hashlib

    def digest(*xs):
        return hashlib.sha256(b"".join(x.float().cpu().numpy().tobytes() for x in xs)
                              ).hexdigest()[:16]

    for B, T, S, Kr, W in ((8, 50, 20, 12, 16), (8, 50, 12, 4, 16), (3, 40, 20, 12, 16)):
        alpha1, src, lpdf, logw, ysm, _ = _steady_case(dev, B, T, S, Kr, W, seed=T + S)
        print(f"digest K3 B{B} T{T} S{S} Kr{Kr}:",
              digest(*nr.steady_forward(alpha1, src, lpdf, logw, ysm)))
    for dtype in DTYPES:
        qkv, bias, g = _attn_case(dev, 8, 50, 4, 64, dtype, seed=7)
        print(f"digest K7 dh64 {dtype}:", digest(at.attention_forward(qkv, bias, 4, 0.125),
                                                 *at.attention_backward(qkv, bias, g, 4, 0.125)))


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
    arc_off, arcs, dst_off = nr.kernel_tables(src, lpdf, logw)
    with pytest.raises(TypeError):  # placed tables must already be int32
        nr.steady_forward(alpha1, src, lpdf, logw, ysm, pre=(arc_off, arcs, dst_off.long()))
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
    "B,T,H,dh",
    [(3, 17, 4, 16), (2, 23, 2, 32), (5, 50, 4, 64), (1, 1, 1, 8), (2, 33, 3, 24),
     (3, 50, 4, 36), (2, 70, 3, 9)],
    ids=["T17", "T23", "main_path_heads", "one_frame", "three_heads", "heads_of_36",
         "odd_heads"],
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
@pytest.mark.parametrize("T", [118, 150, 333, 512])
def test_attention_forward_runs_beyond_the_backward_limit(dev, T, dtype):
    """Both kernels are tiled over T, so neither has a limit in T: at dh 64
    the first design's backward took T <= 117 and its forward T <= 162.
    Here both run at lengths past those, over two to eight key tiles, and
    match the plain versions within the tolerances of
    `test_attention_kernels_match_plain` (the forward's float32 atol as
    chip_smoke.py's)."""
    B, H, dh = 2, 4, 64
    qkv, bias, g = _attn_case(dev, B, T, H, dh, dtype, seed=3)
    scale = 1.0 / math.sqrt(dh)
    n_f, n_b = at.attention_forward.launches, at.attention_backward.launches
    out = at.attention_forward(qkv, bias, H, scale)
    dqkv, dbias = at.attention_backward(qkv, bias, g, H, scale)
    torch.cuda.synchronize()
    assert (at.attention_forward.launches, at.attention_backward.launches) == (n_f + 1, n_b + 1)
    tol = dict(atol=5e-5, rtol=1e-5) if dtype == torch.float32 else dict(atol=2e-2, rtol=1e-2)
    torch.testing.assert_close(out, at.attention_forward_plain(qkv, bias, H, scale), **tol)
    dqkv_p, dbias_p = at.attention_backward_plain(qkv, bias, g, H, scale)
    tol = dict(atol=2e-5, rtol=1e-5) if dtype == torch.float32 else dict(atol=2e-2, rtol=1e-2)
    torch.testing.assert_close(dqkv, dqkv_p, **tol)
    torch.testing.assert_close(dbias, dbias_p, atol=5e-5, rtol=1e-4)
    again = at.attention_backward(qkv, bias, g, H, scale)
    assert torch.equal(again[0], dqkv) and torch.equal(again[1], dbias)


@pytest.mark.parametrize("dtype", DTYPES, ids=["float32", "bfloat16"])
@pytest.mark.parametrize("T", [50, 150])
@pytest.mark.parametrize("dh", [96, 128, 80, 100])
def test_attention_wide_heads_match_plain(dev, dh, T, dtype):
    """Heads past 64 wide take tiles 96 (dh 65-96) and 128 (97-128) wide:
    both kernels against their plain versions at T 50 and 150 within
    chip_smoke.py's tolerances (float32: sums of dh and T products in
    another order; bfloat16: one rounding step), dbias as
    `test_attention_kernels_match_plain`, two launches bit-equal."""
    B, H = 4, 2
    qkv, bias, g = _attn_case(dev, B, T, H, dh, dtype, seed=dh + T)
    scale = 1.0 / math.sqrt(dh)
    out = at.attention_forward(qkv, bias, H, scale)
    dqkv, dbias = at.attention_backward(qkv, bias, g, H, scale)
    torch.cuda.synchronize()
    tol = dict(atol=5e-5, rtol=1e-5) if dtype == torch.float32 else dict(atol=2e-2, rtol=1e-2)
    torch.testing.assert_close(out, at.attention_forward_plain(qkv, bias, H, scale), **tol)
    dqkv_p, dbias_p = at.attention_backward_plain(qkv, bias, g, H, scale)
    torch.testing.assert_close(dqkv, dqkv_p, **tol)
    torch.testing.assert_close(dbias, dbias_p, atol=5e-5, rtol=1e-4)
    assert torch.equal(at.attention_forward(qkv, bias, H, scale), out)
    again = at.attention_backward(qkv, bias, g, H, scale)
    assert torch.equal(again[0], dqkv) and torch.equal(again[1], dbias)


def test_attention_beyond_the_shared_memory_limit_raises(dev):
    """The kernels take heads up to 128 wide (a tile of 64 rows by the
    padded head width per operand): beyond that the wrappers raise, they do
    not fall back."""
    T, H, dh = 40, 1, 136
    qkv = torch.zeros(1, T, 3 * H * dh, device=dev)
    bias = torch.zeros(H, T, T, device=dev)
    n_f, n_b = at.attention_forward.launches, at.attention_backward.launches
    with pytest.raises(ValueError, match="head width"):
        at.attention_forward(qkv, bias, H, 0.1)
    with pytest.raises(ValueError, match="head width"):
        at.attention_backward(qkv, bias, torch.zeros(1, T, H * dh, device=dev), H, 0.1)
    assert (at.attention_forward.launches, at.attention_backward.launches) == (n_f, n_b)


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
     (70, 300, 130, False), (6400, 256, 1024, True), (1000, 256, 200, True),
     (200, 384, 256, True), (640, 512, 2048, True), (70, 1001, 130, True)],
    ids=["aligned", "many_rows", "non_aligned", "tiny", "wide_rows", "conformer",
         "ragged_rows_and_chunk", "d384", "d512", "ragged_column_groups"],
)
def test_ffn_kernels_match_plain(dev, N, D, F, init, dtype):
    # the conformer's shape (and rows and F that are no multiple of the
    # kernels' 64-row tile and 128-column chunk) with the conformer's weight
    # scale: at 0.3, float32 weight gradients over 1000 and more rows reach
    # ~100, and the float32 rounding of such sums in any order (the plain
    # version's cuBLAS sums and an FMA loop's alike) sits at the 1e-4
    # tolerance.  D 384 in float32 streams xn (its tile does not fit);
    # D 512 and 1001 cut the rows into column groups (1001: three, and rows
    # that are not 16-byte aligned)
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


@pytest.mark.parametrize("dtype", DTYPES, ids=["float32", "bfloat16"])
@pytest.mark.parametrize("N,D,F", [(400, 256, 512), (70, 300, 130), (640, 512, 1024)],
                         ids=["conformer_shard", "non_aligned", "column_groups"])
def test_ffn_partial_kernels_match_plain(dev, N, D, F, dtype):
    """K10f/K10b with `partial` (one model rank's share of a split
    half-step: float32 out = alpha h W2 and float32 dx, no residual or b2)
    against their plain versions, at the model axis's shard of the
    conformer (B=8, F 1024 / 2) and at rows the kernels cut or pad."""
    xn, res, w1, b1, w2, b2, g = _ffn_case(dev, N, D, F, dtype, init=True)
    out = ff.ffn_forward(xn, None, w1, b1, w2, None, 0.5, partial=True)
    grads = ff.ffn_backward(xn, g, w1, b1, w2, 0.5, partial=True)
    torch.cuda.synchronize()
    out_p = ff.ffn_forward_plain(xn, None, w1, b1, w2, None, 0.5, partial=True)
    grads_p = ff.ffn_backward_plain(xn, g, w1, b1, w2, 0.5, partial=True)
    assert out.dtype == grads[0].dtype == torch.float32
    kw = (dict(atol=1e-4, rtol=1e-4) if dtype == torch.float32
          else dict(atol=2e-2, rtol=1e-2))
    for got, want, name in zip((out, *grads), (out_p, *grads_p),
                               ("out", "dx", "dw1", "db1", "dw2", "db2")):
        torch.testing.assert_close(got, want, **kw, msg=lambda m, name=name: f"{name}: {m}")


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


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ffn_apply_at_dim_512_launches_the_kernels(dev, dtype):
    """At D 512 (two column groups a row tile) `ffn_apply` launches K10f
    and K10b once each: its output is the kernel's, bit for bit."""
    xn, res, w1, b1, w2, b2, g = _ffn_case(dev, 64, 512, 2048, dtype, seed=2, init=True)
    n = (ff.ffn_forward.launches, ff.ffn_backward.launches)
    leaves = [t.clone().requires_grad_() for t in (xn, res, w1, b1, w2, b2)]
    o = ff.ffn_apply(*leaves, 0.5)
    torch.autograd.grad(o, leaves, g)
    assert (ff.ffn_forward.launches, ff.ffn_backward.launches) == (n[0] + 1, n[1] + 1)
    assert torch.equal(o.detach(), ff.ffn_forward(xn, res, w1, b1, w2, b2, 0.5))


def test_ffn_kernels_raise_on_wrong_input(dev, monkeypatch):
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
    # a card that gives a block less shared memory than a width needs: the
    # wrappers raise before any launch (every width fits the H100's)
    from torchain_tpu_torch import kernels

    monkeypatch.setattr(kernels.library("fused_ffn"), "ffn_shared_limit", lambda: 1024)
    n = (ff.ffn_forward.launches, ff.ffn_backward.launches)
    xn, res, w1, b1, w2, b2, g = _ffn_case(dev, 4, 48, 8, torch.float32)
    with pytest.raises(ValueError, match="shared memory"):
        ff.ffn_forward(xn, res, w1, b1, w2, b2, 0.5)
    with pytest.raises(ValueError, match="shared memory"):
        ff.ffn_backward(xn, g, w1, b1, w2, 0.5)
    assert (ff.ffn_forward.launches, ff.ffn_backward.launches) == n


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
    # the last: more live arcs than a block's shared memory holds; K8f and
    # K8b take their unstaged plans, so no S * K is too large
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


@pytest.mark.parametrize(
    "B,T,S,K,holes,staged",
    [(5, 9, 7, 3, False, 1), (2, 12, 70, 37, True, 1), (2, 3, 300, 120, False, 0)],
    ids=["odd_sizes", "holes_and_wide_rows", "tables_beyond_shared_memory"],
)
def test_e2e_backward_plans_match_plain(dev, B, T, S, K, holes, staged):
    """K8b on each of its shared-memory plans (the list staged, or beta
    alone with the rest read from device memory): the plain version's
    values, exact zeros on pads and for sequences without a finite log p,
    two launches bit-equal, and the unstaged plan, where the sizes chose
    the staged one, bit-equal too."""
    ylocal, src, logw, final = _e2e_case(dev, B, T, S, K, seed=S + 1, holes=holes)
    pre = nr.e2e_kernel_tables(src, logw)
    assert nr.e2e_backward_plan(pre[5].shape[1], S, dev)[1] == staged
    rest = nr.e2e_forward_plain(ylocal, src, logw)
    log_p = torch.logsumexp(rest[-1] + final, dim=-1)
    if B > 2:
        log_p[2] = math.nan
    a0 = torch.full((1, B, S), -math.inf, device=dev)
    a0[:, :, 0] = 0.0
    args = (ylocal, torch.cat([a0, rest[:-1]]), src, logw, final, log_p)
    post_k = nr.e2e_backward_resident(*args, pre=pre)
    torch.cuda.synchronize()
    torch.testing.assert_close(post_k, nr.e2e_backward_plain(*args), atol=1e-5, rtol=1e-4)
    assert (post_k[(src < 0)[:, None].expand_as(post_k)] == 0).all()
    assert (post_k[1] == 0).all()
    if B > 2:
        assert (post_k[2] == 0).all()
    assert torch.equal(nr.e2e_backward_resident(*args, pre=pre), post_k)
    if staged:
        assert torch.equal(nr.e2e_backward_resident(*args, pre=pre, staged=0), post_k)


@pytest.mark.parametrize(
    "B,T,S,K,holes,staged",
    [(5, 9, 7, 3, False, 1), (4, 50, 55, 47, True, 1), (3, 20, 20, 120, False, 1),
     (2, 3, 300, 120, False, 0)],
    ids=["odd_sizes", "heavy_runs", "long_runs", "list_beyond_shared_memory"],
    # heavy_runs: the trigram e2e batch's widths, about 19 live in-arcs a
    # destination, so most runs go to the heavy warps; long_runs: up to 120,
    # past the 48 values a group of them keeps in registers
)
def test_e2e_forward_plans_match_plain(dev, monkeypatch, B, T, S, K, holes, staged):
    """K8f on each of its shared-memory plans: the plain version's values
    within chip_smoke.py's tolerances, -inf where it has them, two launches
    bit-equal, and the unstaged plan, where the sizes chose the staged one,
    bit-equal too (the limit lowered below the staged plan)."""
    ylocal, src, logw, _ = _e2e_case(dev, B, T, S, K, seed=S + 2, holes=holes)
    pre = nr.e2e_kernel_tables(src, logw)
    assert nr.e2e_forward_plan(pre[3].shape[1], S, dev)[1] == staged
    if holes:
        assert int(pre[2].diff(dim=1).max()) > nr.E2E_HEAVY_RUN
    rest_k = nr.e2e_forward_resident(ylocal, src, logw, pre=pre)
    torch.cuda.synchronize()
    _close_where_finite(rest_k, nr.e2e_forward_plain(ylocal, src, logw))
    assert torch.equal(nr.e2e_forward_resident(ylocal, src, logw, pre=pre), rest_k)
    if staged:
        _lower_limit(monkeypatch, dev, k8f=(pre[3].shape[1], S))
        assert torch.equal(nr.e2e_forward_resident(ylocal, src, logw, pre=pre), rest_k)


@pytest.mark.parametrize("staged", [1, 0])
def test_e2e_forward_takes_a_sequence_without_arcs(dev, monkeypatch, staged):
    """A sequence whose graph has no live arc gets -inf from frame 1 on, on
    either plan, and the others the plain version's values."""
    ylocal, src, logw, _ = _e2e_case(dev, 3, 6, 9, 4, seed=3, holes=True)
    src[1] = -1
    logw[1] = -math.inf
    pre = nr.e2e_kernel_tables(src, logw)
    if not staged:
        _lower_limit(monkeypatch, dev, k8f=(pre[3].shape[1], 9))
    rest = nr.e2e_forward_resident(ylocal, src, logw, pre=pre)
    torch.cuda.synchronize()
    assert torch.isneginf(rest[:, 1]).all()
    _close_where_finite(rest, nr.e2e_forward_plain(ylocal, src, logw))


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


def _synthetic_moore(rng, S, E, per_col, dev, pad=8, unentered=2, P=40):
    """A fused dense Moore graph with `per_col` random predecessors per real
    expanded state (out-mass of each state normalised to 1), the last `pad`
    expanded states padding and the first `unentered` original states
    entered by none."""
    from torchain_tpu_torch.graphs import DenseDenGraph
    from torchain_tpu_torch.ops import DeviceDenseDenGraph

    real = E - pad
    orig = np.zeros(E, np.int32)
    orig[:real] = np.sort(rng.integers(unentered, S, size=real))
    V = np.zeros((S, E), np.float32)
    for e in range(real):
        V[rng.choice(S, size=per_col, replace=False), e] = rng.random(per_col) + 0.1
    V /= np.maximum(V.sum(1, keepdims=True), 1e-30)
    init = rng.random(S).astype(np.float32)
    host = DenseDenGraph(num_pdfs=P, num_orig=S, num_exp=E, real_orig=S, real_exp=real, V=V,
                         orig_of_exp=orig, pdf_of_exp=rng.integers(0, P, E).astype(np.int32),
                         init_exp=np.zeros(E, np.float32), initial_probs=init / init.sum())
    return DeviceDenseDenGraph.from_host(host, device=dev, fused=True)


@pytest.fixture(scope="module")
def dense_graphs(dev):
    """The small trigram-biphone graph's Moore form (pad_to 24: padded
    expanded states), where K9f and K9b stage all of V's compressed forms;
    a synthetic graph (24,576 non-zeros) where K9b stages only the CSR and
    reads the CSC through L2; and one (40,960) where neither kernel stages
    any."""
    from torchain_tpu_torch.ops import DeviceDenseDenGraph

    c = tdata.synthetic_dataset(num_utts=12, num_phones=6, feat_dim=8,
                                utt_frames_out=(9, 12), seed=1, lm_order=3,
                                lm_extra_states=50, context_width=2)
    dense = tgraphs.make_dense_den_graph(c.den_graph, pad_to=24)
    small = DeviceDenseDenGraph.from_host(dense, device=dev, fused=True)
    assert small.real_exp < small.num_exp
    rng = np.random.default_rng(5)
    return dict(small=small, l2_csc=_synthetic_moore(rng, 1024, 2048, 12, dev),
                l2=_synthetic_moore(rng, 1024, 2048, 20, dev))


def _device_launches(fn) -> dict[str, int]:
    """Device launches by kernel name (without namespace, template
    arguments or parameters) in one call of `fn`, by torch.profiler.  Every
    call traced here launches a kernel, so a trace without a single device
    event is the profiler's loss (on the H100 the profiler has returned
    such traces in some sessions of a process): `fn` is then traced again,
    up to three times in all."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        out = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                name = e.name.replace("(anonymous namespace)::", "").removeprefix("void ")
                name = name.split("<")[0].split("(")[0]
                out[name] = out.get(name, 0) + 1
        if out:
            break
    return out


#: K9f's and K9b's plans (staged forms, chip_smoke.py's CSC = 1, CSR = 2) by graph
DENSE_PLANS = dict(small=(1, 3), l2_csc=(1, 2), l2=(0, 0))


@pytest.mark.parametrize("leaky", [0.0, 0.1])
@pytest.mark.parametrize("B,T", [(5, 9), (3, 1), (70, 4)],
                         ids=["odd_sizes", "one_frame", "more_rows_than_a_tile"])
@pytest.mark.parametrize("graph", sorted(DENSE_PLANS))
def test_dense_den_kernels_match_plain_and_den_dense(dev, dense_graphs, graph, leaky, B, T):
    """K9f and K9b against their plain versions (the dense V) and the
    fused recursion against ops/den_dense.py, on each of the kernels'
    shared-memory plans: one device launch a call, two launches on the same
    inputs give the same bits, exactly 0 on the padded expanded states."""
    from torchain_tpu_torch.ops import den_dense as dd
    from torchain_tpu_torch.ops import den_pallas as dp

    g = dense_graphs[graph]
    assert tuple(dp.shared_plan(g, d, dev)[1] for d in (0, 1)) == DENSE_PLANS[graph]
    y = torch.as_tensor(np.random.default_rng(B).normal(size=(B, T, g.num_pdfs)),
                        dtype=torch.float32, device=dev)
    n = (dp.dense_forward_kernel.launches, dp.dense_backward_kernel.launches)
    log_z, res = dp.den_forward(y, g, leaky)
    gamma = dp.den_backward(g, res, leaky)
    torch.cuda.synchronize()
    assert (dp.dense_forward_kernel.launches, dp.dense_backward_kernel.launches) == (
        n[0] + 1, n[1] + 1)
    pe = res["pe"]
    logc_p, sig_p = dp.dense_forward_plain(pe, g, leaky)
    # float32 sums in another order: 1e-5 on values of order 1
    torch.testing.assert_close(res["logc"], logc_p, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(res["sigma_hats"], sig_p, atol=1e-6, rtol=1e-4)
    assert _device_launches(lambda: dp.dense_forward_kernel(pe, g, leaky)) == {
        "dense_fwd_kernel": 1}
    again = dp.dense_forward_kernel(pe, g, leaky)
    assert torch.equal(again[0], res["logc"]) and torch.equal(again[1], res["sigma_hats"])
    ymax_t = res["ymax"].T.contiguous()
    F = torch.cumsum(logc_p + ymax_t, 0)
    fscale = torch.cat([F.new_zeros((1, B)), F[:-1]]) + ymax_t - res["log_z"]
    args = (pe, g, sig_p, fscale, ymax_t, leaky)
    gout_k = dp.dense_backward_kernel(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(gout_k, dp.dense_backward_plain(*args), atol=1e-6, rtol=1e-4)
    assert (gout_k[..., g.real_exp:] == 0).all()
    torch.testing.assert_close(gout_k.sum(-1), torch.ones(T, B, device=dev), atol=1e-4, rtol=0)
    # the same kernel twice gives the same bits (no atomics), in one launch
    assert torch.equal(dp.dense_backward_kernel(*args), gout_k)
    assert _device_launches(lambda: dp.dense_backward_kernel(*args)) == {
        "dense_bwd_kernel": 1}
    # and the fused recursion agrees with the matrix-product one
    log_z_d, res_d = dd.den_forward(y, g, leaky)
    torch.testing.assert_close(log_z, log_z_d, atol=1e-4, rtol=1e-5)
    torch.testing.assert_close(gamma, dd.den_backward(g, res_d, leaky), atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("plan", ["staged", "streamed"])
def test_numerator_backward_kernels_are_one_device_launch(dev, plan):
    """K4 and K8b each run as one device launch a call (torch.profiler), on
    either of their shared-memory plans."""
    if plan == "staged":
        k4_case, k8_case = (3, 12, 20, 12, 16), (5, 9, 7, 3, False)
    else:
        k4_case, k8_case = (2, 150, 40, 8, 16), (2, 3, 300, 120, False)
    alpha1, src, lpdf, logw, ysm, final = _steady_case(dev, *k4_case, seed=4)
    pre = nr.kernel_tables(src, lpdf, logw)
    S, W = k4_case[2], k4_case[4]
    want = int(plan == "staged")
    assert nr.steady_plan(pre[1].shape[1], k4_case[1] - 1, S, S * k4_case[3], W, dev)[1] == want
    aT, rest = nr.steady_forward_plain(alpha1, src, lpdf, logw, ysm)
    args = (src, lpdf, logw, ysm, torch.cat([alpha1[None], rest[:-1]]), final,
            torch.logsumexp(aT + final, dim=-1))
    nr.steady_backward(*args, pre=pre)
    assert _device_launches(lambda: nr.steady_backward(*args, pre=pre)) == {
        "steady_bwd_kernel": 1}

    ylocal, src, logw, final = _e2e_case(dev, *k8_case[:4], seed=5, holes=k8_case[4])
    pre = nr.e2e_kernel_tables(src, logw)
    S = k8_case[2]
    assert nr.e2e_backward_plan(pre[5].shape[1], S, dev)[1] == want
    rest = nr.e2e_forward_plain(ylocal, src, logw)
    a0 = torch.full((1, k8_case[0], S), -math.inf, device=dev)
    a0[:, :, 0] = 0.0
    args = (ylocal, torch.cat([a0, rest[:-1]]), src, logw, final,
            torch.logsumexp(rest[-1] + final, dim=-1))
    nr.e2e_backward_resident(*args, pre=pre)
    assert _device_launches(lambda: nr.e2e_backward_resident(*args, pre=pre)) == {
        "e2e_bwd_kernel": 1}


@pytest.mark.parametrize("plan", ["staged", "unstaged"])
def test_numerator_forward_kernels_are_one_device_launch(dev, monkeypatch, plan):
    """K3 and K8f each run as one device launch a call (torch.profiler), on
    either of their shared-memory plans, and read nothing back to the host
    when the placed tables are given (the launches queue behind a sleep of
    the card without waiting for it)."""
    staged = int(plan == "staged")
    alpha1, src, lpdf, logw, ysm, _ = _steady_case(dev, 3, 50, 20, 12, 16, seed=6)
    pre = nr.kernel_tables(src, lpdf, logw)
    ylocal, esrc, elogw, _ = _e2e_case(dev, 4, 20, 55, 47, seed=6, holes=True)
    epre = nr.e2e_kernel_tables(esrc, elogw)
    if not staged:
        _lower_limit(monkeypatch, dev, k3=(pre[1].shape[1], 49, 20, 16),
                     k8f=(epre[3].shape[1], 55))

    def k3():
        return nr.steady_forward(alpha1, src, lpdf, logw, ysm, pre=pre)

    def k8f():
        return nr.e2e_forward_resident(ylocal, esrc, elogw, pre=epre)

    k3(), k8f()
    assert _device_launches(k3) == {"steady_fwd_kernel": 1}
    assert _device_launches(k8f) == {"e2e_fwd_kernel": 1}
    torch.cuda.synchronize()
    done = torch.cuda.Event()
    torch.cuda._sleep(200_000_000)
    k3(), k8f()
    done.record()
    assert not done.query()  # still queued behind the sleep: no host sync
    done.synchronize()


def test_auto_den_graph_falls_through_on_the_card(dev, monkeypatch):
    """With the card's shared-memory limit taken as below the resident
    form's carried state and at the dense form's, `auto_den_graph` picks the
    fused dense Moore form (K9f/K9b), and with the V budget also lowered the
    sparse scan of ops/den_scan.py; the chain loss and its gradient through
    each equal the resident form's within the den forms' tolerances (loss
    rtol 1e-5; gradients rtol 1e-4, atol 1e-6).  The graph: a left-biphone
    bigram over 8 phones, whose 80 pdfs outnumber its states, as
    tests/test_torch_den_auto.py takes it on the CPU."""
    from torchain_tpu_torch import kernels
    from torchain_tpu_torch.ops import ChainLossOptions, DeviceDenGraph, DeviceDenseDenGraph
    from torchain_tpu_torch.ops import chain_loss
    from torchain_tpu_torch.ops import device_graphs as dg

    c = tdata.synthetic_dataset(num_utts=6, num_phones=8, feat_dim=8, utt_frames_out=(9, 12),
                                seed=6, context_width=2, lm_order=2, lm_extra_states=0)
    ds = tdata.ChainDataset(c.utts, c.tree, c.norm_fst, chunk_frames_out=9, left_context=2,
                            right_context=2, sup_opts=tgraphs.SupervisionOptions())
    sup = DeviceSupervision.from_host(next(ds.batches(3, shuffle=False)).sup, device=dev)
    sup = sup.with_kernel_tables()
    g, P = c.den_graph, c.den_graph.num_pdfs
    S_pad, K = dr.slot_sizes(g, 8)
    moore = tgraphs.make_dense_den_graph(g, pad_to=8)
    res_need = kernels.entry("den_resident", "den_shared_bytes")
    dense_need = kernels.entry("den_dense", "dense_shared_bytes")
    resident_bytes = max(res_need(d, S_pad, K, P, 0, 0, 0) for d in (0, 1))
    dense_bytes = max(dense_need(d, moore.num_orig, moore.num_exp, 0, 0, 0) for d in (0, 1))
    assert dense_bytes < resident_bytes
    resident = auto_den_graph(g, pad_to=8, device=dev)
    assert isinstance(resident, dr.DeviceResidentDenGraph)
    monkeypatch.setattr(dg, "den_shared_limit", lambda device: dense_bytes)
    dense = auto_den_graph(g, pad_to=8, device=dev)
    assert isinstance(dense, DeviceDenseDenGraph) and dense.fused
    monkeypatch.setattr(dg, "DENSE_V_BYTES_THRESHOLD", 0)
    scan = auto_den_graph(g, pad_to=8, device=dev)
    assert isinstance(scan, DeviceDenGraph)
    B, T = sup.frame_vocab.shape[:2]
    y = torch.as_tensor(np.random.default_rng(8).normal(size=(B, T, P)), dtype=torch.float32,
                        device=dev)
    opts = ChainLossOptions(l2_regularize=5e-4, leaky_hmm_coefficient=0.1, xent_regularize=0.1)
    out = {}
    for name, den in (("resident", resident), ("dense", dense), ("scan", scan)):
        yy = y.detach().clone().requires_grad_()
        loss, _ = chain_loss(yy, yy * 0.5, den, sup, opts)
        loss.backward()
        out[name] = (loss.detach(), yy.grad)
    for name in ("dense", "scan"):
        torch.testing.assert_close(out[name][0], out["resident"][0], rtol=1e-5, atol=0)
        torch.testing.assert_close(out[name][1], out["resident"][1], rtol=1e-4, atol=1e-6)


def test_dense_den_kernels_refuse_what_they_cannot_hold(dev):
    """A Moore graph whose carried state (two pe rows of 30,000 expanded
    states: 240,000 bytes) exceeds a block's shared memory, and one with
    E = 65,536 (beyond 16-bit indices), raise before any launch; nothing
    falls back."""
    from torchain_tpu_torch.ops import den_pallas as dp

    n = (dp.dense_forward_kernel.launches, dp.dense_backward_kernel.launches)
    for E, match in ((30000, "carried state"), (65536, "16 bits")):
        g = _synthetic_moore(np.random.default_rng(4), 64, E, 1, dev)
        pe = torch.rand(2, 3, E, device=dev)
        with pytest.raises(ValueError, match=match):
            dp.dense_forward_kernel(pe, g, 0.1)
        z = torch.zeros(2, 3, device=dev)
        with pytest.raises(ValueError, match=match):
            dp.dense_backward_kernel(pe, g, torch.rand(2, 3, 64, device=dev), z, z, 0.1)
    assert (dp.dense_forward_kernel.launches, dp.dense_backward_kernel.launches) == n


def test_dense_den_kernels_raise_on_wrong_dtype_and_shape(dev, dense_graphs):
    from torchain_tpu_torch.ops import den_pallas as dp

    g = dense_graphs["small"]
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


# ---------------------------------------------------------------------------
# records read from a merged cegs archive, on the card
# ---------------------------------------------------------------------------


def _e2e_record_and_batch(c, ds, B):
    """The first B utterances E2eChainDataset keeps, as one merged e2e
    record (make_e2e_chain_example) and as the dataset's own first batch."""
    from torchain_tpu_torch.data import make_e2e_chain_example
    from torchain_tpu_torch.graphs import make_e2e_supervision_fst

    fsts, feats = [], []
    for ui, utt in enumerate(ds.utts):
        if ds._sup_of(ui) is None:
            continue
        starts = np.cumsum([0] + [d for _, d in utt.alignment])[:-1] // ds.fsf
        keep = [p for (p, _d), s in zip(utt.alignment, starts) if s < ds.chunk_frames_out]
        fsts.append(make_e2e_supervision_fst(keep, c.tree, ds._norm_ready, norm_ready=True))
        idx = np.clip(np.arange(-ds.left_context,
                                ds.chunk_frames_out * ds.fsf + ds.right_context),
                      0, utt.feats.shape[0] - 1)
        feats.append(utt.feats[idx])
        if len(fsts) == B:
            break
    eg = make_e2e_chain_example(np.stack(feats), fsts, c.tree.num_pdfs,
                                frames_per_sequence=ds.chunk_frames_out,
                                frame_subsampling_factor=ds.fsf, left_context=ds.left_context)
    return eg, next(ds.batches(B, shuffle=False))


@pytest.mark.parametrize("e2e", [False, True], ids=["standard", "e2e"])
def test_a_cegs_record_trains_like_the_in_process_batch(dev, tmp_path, e2e):
    """A small record written to a merged cegs archive and read back
    (CegsDataset) gives, on the card, the in-process batch's chain loss
    within 1e-5 relative, through K1-K6 (K1, K2, K8f, K8b for e2e)."""
    from torchain_tpu_torch.data import CegsDataset, dataset_to_cegs, write_cegs_ark
    from torchain_tpu_torch.ops import ChainLossOptions, DeviceE2eSupervision, chain_loss

    B, T = 4, 12
    c = tdata.synthetic_dataset(num_utts=10, num_phones=8, feat_dim=8, utt_frames_out=(12, 16),
                                seed=3, lm_order=3, lm_extra_states=40)
    ark = str(tmp_path / "cegs.1.ark")
    if e2e:
        ds = tdata.E2eChainDataset(c.utts, c.tree, c.norm_fst, chunk_frames_out=T,
                                   left_context=3, right_context=3)
        eg, ref = _e2e_record_and_batch(c, ds, B)
        write_cegs_ark(ark, {"eg-0": eg})
        cls, kernels = DeviceE2eSupervision, (dr.den_forward_kernel, dr.den_backward_kernel,
                                              nr.e2e_forward_resident, nr.e2e_backward_resident)
    else:
        ds = tdata.ChainDataset(c.utts, c.tree, c.norm_fst, chunk_frames_out=T,
                                left_context=3, right_context=3,
                                sup_opts=tgraphs.SupervisionOptions())
        assert dataset_to_cegs(ds, ark, batch_size=B) >= 1
        ref = next(ds.batches(B, shuffle=False))
        cls, kernels = DeviceSupervision, (dr.den_forward_kernel, dr.den_backward_kernel,
                                           nr.steady_forward, nr.steady_backward,
                                           ns.vocab_gather, ns.vocab_scatter)
    batch = next(CegsDataset(ark).batches(0, shuffle=False))
    np.testing.assert_array_equal(batch.feats, ref.feats)
    den = auto_den_graph(c.den_graph, device=dev)
    y = torch.as_tensor(np.random.default_rng(7).normal(size=(B, T, den.num_pdfs)),
                        dtype=torch.float32, device=dev)
    opts = ChainLossOptions(leaky_hmm_coefficient=0.1, l2_regularize=5e-4)
    losses = []
    for host in (ref.sup, batch.sup):
        sup = cls.from_host(host, device=dev).with_kernel_tables()
        before = [k.launches for k in kernels]
        yy = y.clone().requires_grad_(True)
        loss, _aux = chain_loss(yy, None, den, sup, opts)
        loss.backward()
        assert all(k.launches > n for k, n in zip(kernels, before))
        assert torch.isfinite(yy.grad).all()
        losses.append(float(loss.detach()))
    assert math.isfinite(losses[1])
    assert abs(losses[1] - losses[0]) <= 1e-5 * abs(losses[0]), losses


@pytest.fixture(scope="module")
def decode_setup(dev):
    """A small word corpus and TDNN-F (seeded), its word HCLG, and the
    model on the card and on the CPU from the same weights."""
    from torchain_tpu_torch.eval import make_word_decoding_graph
    from torchain_tpu_torch.models import TDNNF, TdnnfConfig

    words = tdata.synthetic_word_dataset(num_utts=6, vocab_size=8, num_phones=6, feat_dim=8,
                                         seed=3)
    tree = words.corpus.tree
    cfg = TdnnfConfig(num_pdfs=tree.num_pdfs, hidden_dim=64, bottleneck_dim=16,
                      prefinal_dim=32, num_layers=3)
    cpu = TDNNF(cfg, 8, device="cpu", generator=torch.Generator().manual_seed(4))
    card = TDNNF(cfg, 8, device=dev)
    card.load_state_dict(cpu.state_dict())
    graph = make_word_decoding_graph(tdata.train_word_lm(words.transcripts), words.lexicon, tree)
    return words, cfg, cpu, card, graph


def test_decode_forward_at_b1_on_card_matches_cpu(decode_setup):
    """The decode stages' forward (one utterance at a time, B=1) on the card
    against the CPU, within chip_smoke's float32 reference gate in norm;
    then the native decoders over the card's posteriors give the NumPy
    reference's hypotheses."""
    from torchain_tpu_torch.cli.train import _posteriors
    from torchain_tpu_torch.eval import lattice_best_path, lattice_decode, viterbi_decode

    words, cfg, cpu, card, graph = decode_setup
    left, right = cfg.context
    on_card, _ = _posteriors(card, words.corpus.utts, left, right, 3)
    on_cpu, _ = _posteriors(cpu, words.corpus.utts, left, right, 3)
    for a, b in zip(on_card, on_cpu):
        assert a.shape == b.shape and np.isfinite(a).all()
        assert np.linalg.norm(a - b) / np.linalg.norm(b) <= chip_smoke.REFERENCE_RTOL["float32"]
    for y in on_card:
        hn, sn = viterbi_decode(graph, y, backend="native")
        hp, sp = viterbi_decode(graph, y, backend="numpy")
        assert hn == hp and sn == pytest.approx(sp, rel=1e-4)
        ln = lattice_decode(graph, y, beam=8.0, backend="native")
        lp = lattice_decode(graph, y, beam=8.0, backend="numpy")
        assert ln.num_arcs == lp.num_arcs
        assert lattice_best_path(ln)[0] == lattice_best_path(lp)[0] == viterbi_decode(
            graph, y, beam=8.0, backend="native")[0]


def test_align_corpus_from_the_card(decode_setup):
    """align_corpus over the card's forward: the CPU forward's alignments,
    each covering its utterance with the transcript's phones."""
    from torchain_tpu_torch.eval import align_corpus
    from torchain_tpu_torch.train.step import make_forward_fn

    words, cfg, cpu, card, _ = decode_setup
    left, right = cfg.context
    ctx = dict(frame_subsampling_factor=3, left_context=left, right_context=right)
    tree, utts = words.corpus.tree, words.corpus.utts
    forward = make_forward_fn(card)
    assert forward.device.type == "cuda"
    got = align_corpus(forward, utts, tree, **ctx)
    assert got == align_corpus(make_forward_fn(cpu), utts, tree, **ctx)
    for u, ali in zip(utts, got):
        assert sum(d for _, d in ali) == u.feats.shape[0]
        assert [p for p, _ in ali] == [p for p, _ in u.alignment]


# ---------------------------------------------------------------------------
# Tied trees: a triphone supervision through K3-K6, tied-tree den graphs
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tied_setup(dev):
    """The synthetic corpus of 6 phones with a tied tree of 60 pdfs from its
    alignments, in each context window (cli.train's stage 0t), and a B=6
    batch of its chunks."""
    import argparse

    from torchain_tpu_torch.cli.train import tied_tree_stage

    out = {}
    for context in ("left", "triphone"):
        c = tdata.synthetic_dataset(num_utts=24, num_phones=6, feat_dim=8,
                                    utt_frames_out=(12, 20), seed=3)
        tied_tree_stage(argparse.Namespace(tied_tree_pdfs=60, tied_tree_context=context,
                                           num_phones=6), c)
        ds = tdata.ChainDataset(c.utts, c.tree, c.norm_fst, chunk_frames_out=12,
                                left_context=2, right_context=2,
                                sup_opts=tgraphs.SupervisionOptions())
        out[context] = (c, next(ds.batches(6, shuffle=False)))
    return out


def test_triphone_supervision_through_the_numerator_kernels(tied_setup):
    """A triphone TiedTree's supervision batch through K5, K3, K4 and K6 on
    the card against the plain versions on the CPU."""
    c, batch = tied_setup["triphone"]
    assert c.tree.right_dependent(0) or c.tree.right_dependent(1)
    sup = DeviceSupervision.from_host(batch.sup, device="cuda")
    B, T = sup.frame_vocab.shape[:2]
    y = torch.as_tensor(np.random.default_rng(4).normal(size=(B, T, c.tree.num_pdfs)),
                        dtype=torch.float32, device="cuda")
    lp_c, al_c = ns.num_forward(y.cpu(), sup.to("cpu"))
    g_c = ns.num_backward(y.cpu(), sup.to("cpu"), lp_c, al_c)
    counts = [f.launches for f in (nr.steady_forward, nr.steady_backward, ns.vocab_gather,
                                   ns.vocab_scatter)]
    s = sup.with_kernel_tables()
    lp, al = ns.num_forward(y, s)
    g = ns.num_backward(y, s, lp, al)
    torch.cuda.synchronize()
    now = [f.launches for f in (nr.steady_forward, nr.steady_backward, ns.vocab_gather,
                                ns.vocab_scatter)]
    assert all(b > a for a, b in zip(counts, now)), (counts, now)
    torch.testing.assert_close(lp.cpu(), lp_c, atol=1e-5, rtol=1e-5)
    _close_where_finite(al.cpu(), al_c)
    torch.testing.assert_close(g.cpu(), g_c, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("context", ["left", "triphone"])
def test_tied_tree_chain_loss_on_card_matches_cpu(tied_setup, context):
    """A tied tree's den graph through `auto_den_graph` (the same form on
    both devices) and the chain loss, on the card against the CPU."""
    from torchain_tpu_torch.ops import ChainLossOptions, chain_loss

    c, batch = tied_setup[context]
    opts = ChainLossOptions(l2_regularize=5e-4, leaky_hmm_coefficient=0.1, xent_regularize=0.1)
    B, T = batch.sup.in_src.shape[:2]
    y = np.random.default_rng(5).normal(size=(B, T, c.tree.num_pdfs)).astype(np.float32)
    out = {}
    for d in ("cuda", "cpu"):
        den = auto_den_graph(c.den_graph, device=d)
        sup = DeviceSupervision.from_host(batch.sup, device=d).with_kernel_tables()
        yy = torch.tensor(y, device=d, requires_grad=True)
        loss, aux = chain_loss(yy, yy * 0.5, den, sup, opts)
        loss.backward()
        out[d] = (type(den), loss.detach().cpu(), yy.grad.cpu(), float(aux["num_failed"]))
    assert out["cuda"][0] is out["cpu"][0]
    assert out["cuda"][3] == out["cpu"][3] == 0.0
    torch.testing.assert_close(out["cuda"][1], out["cpu"][1], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(out["cuda"][2], out["cpu"][2], rtol=1e-4, atol=1e-6)


# ---------------------------------------------------------------------------
# The train step as one captured CUDA graph (train/captured.py)
# ---------------------------------------------------------------------------

CAPTURE_OPTS = dict(l2_regularize=5e-4, leaky_hmm_coefficient=0.1, xent_regularize=0.1)


def _captured_case(dev, sup_kind: str, model_kind: str):
    """A small corpus's batches A and B, padded to one set of caps with
    lists of one width, on the card; its den graph; a model config."""
    from torchain_tpu_torch.models import ConformerConfig, TdnnfConfig
    from torchain_tpu_torch.ops import DeviceDenseDenGraph, DeviceE2eSupervision

    c = tdata.synthetic_dataset(num_utts=12, num_phones=6, feat_dim=8, utt_frames_out=(9, 12),
                                seed=1, lm_order=3, lm_extra_states=50)
    if model_kind == "conformer":
        cfg = ConformerConfig(num_pdfs=c.tree.num_pdfs, dim=32, num_layers=2, num_heads=2,
                              prefinal_dim=16, ffn_impl="fused", dtype=torch.bfloat16)
    else:
        cfg = TdnnfConfig(num_pdfs=c.tree.num_pdfs, hidden_dim=64, bottleneck_dim=16,
                          prefinal_dim=32, num_layers=3)
    left, right = cfg.context
    common = dict(chunk_frames_out=9, left_context=left, right_context=right)
    if sup_kind == "e2e":
        ds = tdata.E2eChainDataset(c.utts, c.tree, c.norm_fst, **common)
        caps = ds.estimate_e2e_caps()
        it, L = ds.batches(4, shuffle=False, sup_caps=caps), caps[3]

        def put(s):
            return DeviceE2eSupervision.from_host(s, device=dev, vocab_cap=caps[2])
    else:
        ds = tdata.ChainDataset(c.utts, c.tree, c.norm_fst,
                                sup_opts=tgraphs.SupervisionOptions(), **common)
        it = ds.batches(4, shuffle=False, sup_caps=ds.estimate_sup_caps())
        L = ds.estimate_live_arcs()

        def put(s):
            return DeviceSupervision.from_host(s, device=dev)
    batches = [(torch.as_tensor(b.feats, device=dev), put(b.sup).with_kernel_tables(L_cap=L))
               for b in (next(it), next(it))]
    if sup_kind == "dense":
        den = DeviceDenseDenGraph.from_host(tgraphs.make_dense_den_graph(c.den_graph, pad_to=8),
                                            device=dev, fused=True)
    else:
        den = auto_den_graph(c.den_graph, pad_to=32, device=dev)
    return c, cfg, batches, den


def _train(step, den, batches, n):
    out = []
    for i in range(n):
        feats, sup = batches[i % 2]
        out.append({k: float(v) for k, v in step(feats, den, sup).items()})
    return out


#: the port's kernels, by their device names (`_device_launches`)
PORT_KERNELS = ("den_fwd_kernel", "den_bwd_kernel", "steady_fwd_kernel", "steady_bwd_kernel",
                "vocab_gather_kernel", "vocab_scatter_kernel", "attn_fwd_kernel",
                "attn_bwd_rows_kernel", "attn_bwd_cols_kernel", "dbias_reduce_kernel",
                "ffn_fwd_kernel", "ffn_bwd_rows_kernel", "ffn_bwd_weights_kernel",
                "e2e_fwd_kernel", "e2e_bwd_kernel", "dense_fwd_kernel", "dense_bwd_kernel")


@pytest.mark.parametrize("sup_kind,model_kind", [
    ("standard", "tdnnf"), ("e2e", "tdnnf"), ("dense", "tdnnf"), ("standard", "conformer")])
def test_captured_step_replays_the_eager_step(dev, sup_kind, model_kind):
    """Captured on batch A, replayed on A, B, A, B, A: the eager step's
    metrics (float32 trunk: step 1 rel 1e-6, later 1e-4; bf16: 1e-5, 1e-3)
    and its launch counts."""
    from torchain_tpu_torch.models import TDNNF, Conformer
    from torchain_tpu_torch.ops import ChainLossOptions
    from torchain_tpu_torch.train import create_train_state, make_train_step

    c, cfg, batches, den = _captured_case(dev, sup_kind, model_kind)
    cls = Conformer if model_kind == "conformer" else TDNNF
    model = cls(cfg, c.feat_dim, device=dev, generator=torch.Generator().manual_seed(0))
    state = create_train_state(model, capturable=True)
    opts = ChainLossOptions(**CAPTURE_OPTS)
    eager = make_train_step(state, opts)
    captured = make_train_step(state, opts, capture=True)
    init = captured.snapshot()
    captured.capture(batches[0][0], den, batches[0][1])
    assert captured.pool_bytes is not None and captured.capture_s > 0
    captured.restore(init)
    want = _train(eager, den, batches, 5)
    captured.restore(init)
    state.step = 0
    got = _train(captured, den, batches, 5)
    assert state.step == 5
    rtol1, rtol = (1e-5, 1e-3) if model_kind == "conformer" else (1e-6, 1e-4)
    for i, (g, w) in enumerate(zip(got, want)):
        for k in ("loss", "objf", "grad_norm"):
            assert math.isclose(g[k], w[k], rel_tol=rtol1 if i == 0 else rtol), (i, k, g, w)
    assert got[-1]["loss"] < got[0]["loss"]
    # a replay runs no Python: its launches are read from a trace
    n = {mode: {k: v for k, v in _device_launches(lambda: _train(step, den, batches, 5)).items()
                if k in PORT_KERNELS}
         for mode, step in (("eager", eager), ("captured", captured))}
    assert n["captured"] == n["eager"]
    assert n["eager"].get("den_bwd_kernel", 0) == (0 if sup_kind == "dense" else 5)


def test_captured_step_refuses_another_shape_or_graph(dev):
    from torchain_tpu_torch.models import TDNNF
    from torchain_tpu_torch.ops import ChainLossOptions
    from torchain_tpu_torch.train import create_train_state, make_train_step

    c, cfg, batches, den = _captured_case(dev, "standard", "tdnnf")
    state = create_train_state(TDNNF(cfg, c.feat_dim, device=dev), capturable=True)
    step = make_train_step(state, ChainLossOptions(**CAPTURE_OPTS), capture=True)
    step(batches[0][0], den, batches[0][1])
    feats, sup = batches[1]
    with pytest.raises(ValueError, match="sup.arcs_k"):
        step(feats, den, sup.with_kernel_tables(L_cap=sup.arcs_k.shape[1] + 1))
    with pytest.raises(ValueError, match="den"):
        step(feats, auto_den_graph(c.den_graph, pad_to=32, device=dev), sup)
    with pytest.raises(ValueError, match="capturable=True"):
        make_train_step(create_train_state(TDNNF(cfg, c.feat_dim, device=dev)),
                        ChainLossOptions(**CAPTURE_OPTS), capture=True)


def test_capturable_adam_steps_like_the_default(dev):
    """Five eager steps with Adam(capturable=True) and with the default,
    from the same weights: float32 rounding apart."""
    from torchain_tpu_torch.models import TDNNF
    from torchain_tpu_torch.ops import ChainLossOptions
    from torchain_tpu_torch.train import create_train_state, make_train_step

    c, cfg, batches, den = _captured_case(dev, "standard", "tdnnf")
    runs = []
    for capturable in (True, False):
        model = TDNNF(cfg, c.feat_dim, device=dev, generator=torch.Generator().manual_seed(0))
        step = make_train_step(create_train_state(model, capturable=capturable),
                               ChainLossOptions(**CAPTURE_OPTS))
        runs.append(_train(step, den, batches, 5))
    for a, b in zip(*runs):
        for k in ("loss", "grad_norm"):
            assert math.isclose(a[k], b[k], rel_tol=1e-5), (k, a, b)
