"""The flat-start (e2e) path of the PyTorch port against the JAX package:
host tables (graphs/e2e.py, E2eChainDataset, the per-sequence vocabulary),
the recursions of ops/num_e2e.py, the plain versions of kernels K8f/K8b
(which the wrappers run on CPU tensors) and the chain loss with a
DeviceE2eSupervision.

Same corpus, batch and numpy log-probs on both sides.  The JAX package runs
under TORCHAIN_NUM_RESIDENT=0 (lax.scan) and =force (its Pallas kernels in
interpret mode).  Tolerances: host tables equal exactly; log-probs, alphas
and occupancies rtol/atol 1e-5 (float32 log-sum-exps of a few terms in
another order, carried over T frames; -inf in the same places); the chain
loss rtol 1e-5 and its gradients atol 1e-6, as tests/test_torch_chain_loss.py."""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")

import jax
import jax.numpy as jnp
import torch

import torchain_tpu.data as jdata
import torchain_tpu.graphs.e2e as je2e
import torchain_tpu.ops as jops
import torchain_tpu_torch.data as tdata
import torchain_tpu_torch.graphs as tgraphs
import torchain_tpu_torch.ops as tops
from torchain_tpu.ops import num_e2e as jne
from torchain_tpu.ops import num_resident as jnr
from torchain_tpu.ops.den_resident import DeviceResidentDenGraph as JResident
from torchain_tpu_torch.ops import num_e2e as tne
from torchain_tpu_torch.ops import num_resident as tnr

CORPUS = dict(num_utts=10, num_phones=8, feat_dim=8, utt_frames_out=(12, 16), seed=3,
              lm_order=3, lm_extra_states=40)
B, T = 4, 12
OPTS = dict(l2_regularize=5e-4, leaky_hmm_coefficient=0.1, xent_regularize=0.1)
TOL = dict(rtol=1e-5, atol=1e-5)


def _batch(pkg):
    c = pkg.synthetic_dataset(**CORPUS)
    ds = pkg.E2eChainDataset(c.utts, c.tree, c.norm_fst, chunk_frames_out=T,
                             left_context=3, right_context=3)
    return c, ds, next(ds.batches(B, shuffle=False))


@pytest.fixture(scope="module")
def sides():
    (jc, jds, jb), (tc, tds, tb) = _batch(jdata), _batch(tdata)
    rng = np.random.default_rng(5)
    y = rng.normal(size=(B, T, jc.tree.num_pdfs)).astype(np.float32)
    return dict(jc=jc, jb=jb, tc=tc, tb=tb, tds=tds, jds=jds, y=y,
                jsup=jne.DeviceE2eSupervision.from_host(jb.sup),
                tsup=tne.DeviceE2eSupervision.from_host(tb.sup, device="cpu"))


def _assert_same_fields(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if x is None:
            assert y is None, f.name
        else:
            np.testing.assert_array_equal(np.asarray(y), np.asarray(x), err_msg=f.name)


def test_e2e_host_tables_equal_jax(sides):
    """One transcript through both packages' graphs/e2e.py, and one batch
    through both E2eChainDatasets: every table equal, none dropped."""
    jc, tc = sides["jc"], sides["tc"]
    phones = [p for p, _ in jc.utts[0].alignment][:4]
    jfst = je2e.make_e2e_supervision_fst(phones, jc.tree, jc.norm_fst)
    tfst = tgraphs.make_e2e_supervision_fst(phones, tc.tree, tc.norm_fst)
    assert tfst.num_states == jfst.num_states and tfst.num_arcs == jfst.num_arcs
    _assert_same_fields(je2e.compile_e2e_supervision(jfst, T, jc.tree.num_pdfs),
                        tgraphs.compile_e2e_supervision(tfst, T, tc.tree.num_pdfs))
    np.testing.assert_array_equal(sides["tb"].feats, sides["jb"].feats)
    _assert_same_fields(sides["jb"].sup, sides["tb"].sup)
    assert sides["tds"].num_dropped == sides["jds"].num_dropped == 0
    assert sides["tb"].sup.in_src.shape[0] == B
    with pytest.raises(ValueError, match="empty transcript"):
        tgraphs.transcript_to_e2e_fst([], tc.tree)


def test_e2e_dataset_caches_and_counts_drops():
    """A cached utterance is compiled once; one too short for the chunk is
    dropped and counted once over two epochs."""
    c = tdata.synthetic_dataset(**CORPUS)
    short = tdata.Utterance(feats=c.utts[0].feats[:9], alignment=c.utts[0].alignment[:1])
    ds = tdata.E2eChainDataset(c.utts[:4] + [short], c.tree, c.norm_fst, chunk_frames_out=T,
                               left_context=3, right_context=3)
    first = [b.sup.in_src for b in ds.batches(2, shuffle=False)]
    cached = dict(ds._sup_cache)
    second = [b.sup.in_src for b in ds.batches(2, shuffle=False)]
    assert ds.num_dropped == 1 and len(first) == len(second) == 2
    assert all(ds._sup_cache[k] is v for k, v in cached.items())
    for a, b in zip(first, second):
        np.testing.assert_array_equal(a, b)


def test_seq_vocab_tables_and_device_supervision_equal_jax(sides):
    jb, tb = sides["jb"].sup, sides["tb"].sup
    jv, jl = jne._seq_vocab_tables(jb.in_src, jb.in_pdf)
    tv, tl = tne._seq_vocab_tables(tb.in_src, tb.in_pdf)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tl, jl)
    jsup, tsup = sides["jsup"], sides["tsup"]
    for name in ("in_src", "in_pdf", "in_logw", "final_logw", "weight", "vocab", "pdf_local"):
        np.testing.assert_array_equal(getattr(tsup, name).numpy(),
                                      np.asarray(getattr(jsup, name)), err_msg=name)
    for name in ("num_frames", "max_states", "max_arcs", "num_pdfs"):
        assert getattr(tsup, name) == getattr(jsup, name)
    # a single (unbatched) supervision gets a leading batch dim of 1
    one = tgraphs.compile_e2e_supervision(
        tgraphs.make_e2e_supervision_fst([1, 2], sides["tc"].tree, sides["tc"].norm_fst),
        T, sides["tc"].tree.num_pdfs)
    assert tne.DeviceE2eSupervision.from_host(one, device="cpu").in_src.shape[0] == 1


def test_arc_emissions_equal_jax(sides):
    """Two gathers against the JAX package's two one-hot products: exact."""
    jyl = jne._arc_emissions(jnp.asarray(sides["y"]), sides["jsup"])
    tyl = tne._arc_emissions(torch.as_tensor(sides["y"]), sides["tsup"])
    live = sides["tb"].sup.in_src >= 0
    assert tyl.shape == jyl.shape == (B, T) + live.shape[1:] and tyl.dtype == torch.float32
    mask = np.broadcast_to(live[:, None], tyl.shape)
    np.testing.assert_array_equal(tyl.numpy()[mask], np.asarray(jyl)[mask])


def _assert_close_with_infs(got, want):
    got, want = np.asarray(got), np.asarray(want)
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    np.testing.assert_allclose(got[fin], want[fin], **TOL)


@pytest.mark.parametrize("resident", ["0", "force"])
@pytest.mark.parametrize("kernel_tables", [False, True])
def test_e2e_forward_backward_match_jax(sides, monkeypatch, resident, kernel_tables):
    monkeypatch.setenv("TORCHAIN_NUM_RESIDENT", resident)
    y, jsup = sides["y"], sides["jsup"]
    tsup = sides["tsup"].with_kernel_tables() if kernel_tables else sides["tsup"]
    lp_j, al_j = jne.e2e_forward(jnp.asarray(y), jsup)
    g_j = jne.e2e_backward(jnp.asarray(y), jsup, lp_j, al_j)
    yt = torch.as_tensor(y)
    lp_t, al_t = tne.e2e_forward(yt, tsup)
    g_t = tne.e2e_backward(yt, tsup, lp_t, al_t)
    assert np.isfinite(np.asarray(lp_j)).all()
    np.testing.assert_allclose(lp_t.numpy(), np.asarray(lp_j), **TOL)
    _assert_close_with_infs(al_t.numpy(), al_j)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), **TOL)
    # occupancies: each frame of each sequence sums to one
    np.testing.assert_allclose(g_t.sum(-1).numpy(), 1.0, atol=1e-5)


def _kernel_inputs(sides):
    sup = sides["tb"].sup
    ylocal = tne._arc_emissions(torch.as_tensor(sides["y"]), sides["tsup"])
    return ylocal, sup.in_src, sup.in_logw, sup.final_logw


def test_k8_plain_versions_match_pallas_interpret(sides):
    """e2e_forward_resident / e2e_backward_resident on CPU tensors (the K8
    plain versions) against the Pallas kernels in interpret mode, on the
    same ylocal; sequence 1 impossible (no final state), sequence 2 with a
    NaN log_p: exact zeros for both."""
    ylocal, src, logw, final = _kernel_inputs(sides)
    rest_j = jnr.e2e_forward_resident(jnp.asarray(ylocal.numpy()), jnp.asarray(src),
                                      jnp.asarray(logw), interpret=True)
    n_f, n_b = tnr.e2e_forward_resident.launches, tnr.e2e_backward_resident.launches
    rest_t = tnr.e2e_forward_resident(ylocal, torch.as_tensor(src), torch.as_tensor(logw))
    assert rest_t.shape == (T, B, src.shape[1])
    _assert_close_with_infs(rest_t.numpy(), rest_j)

    final = final.copy()
    final[1] = -np.inf
    a0 = np.full((1, B, src.shape[1]), -np.inf, np.float32)
    a0[:, :, 0] = 0.0
    alphas = np.concatenate([a0, np.asarray(rest_j)[:-1]])
    log_p = np.asarray(jax.nn.logsumexp(rest_j[-1] + final, axis=-1)).copy()
    assert np.isneginf(log_p[1])
    log_p[2] = np.nan
    post_j = jnr.e2e_backward_resident(
        jnp.asarray(ylocal.numpy()), jnp.asarray(alphas), jnp.asarray(src), jnp.asarray(logw),
        jnp.asarray(final), jnp.asarray(log_p), interpret=True)
    post_t = tnr.e2e_backward_resident(
        ylocal, torch.as_tensor(alphas), torch.as_tensor(src), torch.as_tensor(logw),
        torch.as_tensor(final), torch.as_tensor(log_p))
    assert (post_t[1] == 0).all() and (post_t[2] == 0).all()
    assert torch.isfinite(post_t).all()
    assert (post_t.numpy()[np.broadcast_to((src < 0)[:, None], post_t.shape)] == 0).all()
    np.testing.assert_allclose(post_t.numpy(), np.asarray(post_j), **TOL)
    # the plain versions ran: nothing was launched
    assert (tnr.e2e_forward_resident.launches, tnr.e2e_backward_resident.launches) == (n_f, n_b)


def emulate_e2e_backward(pre, ylocal, alphas, final_logw, log_p):
    """K8b as csrc/num_e2e.cu computes it, on the staged list of `pre`
    (each sequence's live slots in source order, slot order within one
    source): per frame, in reverse, each arc's posterior at its slot (every
    other slot 0); a source state's run of up to E2E_HEAVY_RUN arcs reduced
    in list order, one float32 addition at a time, a longer one by 32 lanes
    (lane g takes arcs g, g + 32, ... in order, then lane l adds lane
    l ^ off for off = 16 .. 1); the maximum first.  Elementwise values by
    torch's float32 operations."""
    src32, logw32, _, _, by_off, by_arc = pre
    B, T, S, K = ylocal.shape
    logp = torch.where(torch.isfinite(log_p), log_p, torch.inf)
    post = torch.zeros((B, T, S * K))
    for b in range(B):
        slot = by_arc[b, :by_off[b, S]].long()
        sp, dst, lw = src32[b].reshape(-1)[slot].long(), slot // K, logw32[b].reshape(-1)[slot]
        beta = final_logw[b]
        for t in range(T - 1, -1, -1):
            aw = (lw + ylocal[b, t].reshape(-1)[slot]) + beta[dst]
            post[b, t, slot] = torch.exp(alphas[t, b, sp] + aw - logp[b])
            nxt = torch.full((S,), -torch.inf)
            for s in range(S):
                run = aw[by_off[b, s]:by_off[b, s + 1]]
                m = run.max() if len(run) else torch.tensor(-torch.inf)
                if m > -torch.inf:
                    G = 1 if len(run) <= tnr.E2E_HEAVY_RUN else 32
                    lanes = []
                    for g in range(G):
                        acc = torch.tensor(0.0)
                        for v in torch.exp(run[g::G] - m):
                            acc = acc + v
                        lanes.append(acc)
                    off = G // 2
                    while off:
                        lanes = [lanes[i] + lanes[i ^ off] for i in range(G)]
                        off //= 2
                    nxt[s] = m + torch.log(lanes[0])
            beta = nxt
    return post.view(B, T, S, K)


def _lanes_lse(run):
    """A run's log-sum-exp as K8f reduces it: up to E2E_HEAVY_RUN values in
    order, one float32 addition at a time; a longer run by a group of 8
    lanes (lane g takes values g, g + 8, ... in order, then lane l adds lane
    l ^ off for off = 4, 2, 1); the maximum first, -inf where it is."""
    m = run.max() if len(run) else torch.tensor(-torch.inf)
    if not m > -torch.inf:
        return torch.tensor(-torch.inf)
    G = 1 if len(run) <= tnr.E2E_HEAVY_RUN else 8
    lanes = []
    for g in range(G):
        acc = torch.tensor(0.0)
        for v in torch.exp(run[g::G] - m):
            acc = acc + v
        lanes.append(acc)
    off = G // 2
    while off:
        lanes = [lanes[i] + lanes[i ^ off] for i in range(G)]
        off //= 2
    return m + torch.log(lanes[0])


def emulate_e2e_forward(pre, ylocal):
    """K8f as csrc/num_e2e.cu computes it, on the by-destination list of
    `pre` (each sequence's live slots in slot order): per frame, each
    destination's run of values (alpha[src] + logw) + ylocal reduced as
    `_lanes_lse` does.  Returns the alphas [T, B, S]."""
    src32, logw32, in_off, in_arc, _, _ = pre
    B, T, S, K = ylocal.shape
    out = torch.empty((T, B, S))
    for b in range(B):
        slot = in_arc[b, :in_off[b, S]].long()
        sp, lw = src32[b].reshape(-1)[slot].long(), logw32[b].reshape(-1)[slot]
        assert (slot // K).diff().ge(0).all()  # destination order
        alpha = torch.full((S,), -torch.inf)
        alpha[0] = 0.0
        for t in range(T):
            v = (alpha[sp] + lw) + ylocal[b, t].reshape(-1)[slot]
            alpha = torch.stack([_lanes_lse(v[in_off[b, s]:in_off[b, s + 1]])
                                 for s in range(S)])
            out[t, b] = alpha
    return out


def _heavy_inputs():
    """Tables (B=2, S=6, K=64) where state 3 of sequence 0 has 60 in-arcs
    (past the 48 a group of the heavy warps keeps in registers) and state 5
    has 9 (runs for the heavy warps), the others 0 to 3, with per-arc
    emissions for 12 frames."""
    rng = np.random.default_rng(9)
    B_, T_, S, K = 2, 12, 6, 64
    src = np.full((B_, S, K), -1)
    for b in range(B_):
        for s in range(1, S):
            n = 60 if (b, s) == (0, 3) else 9 if s == 5 else rng.integers(0, 4)
            src[b, s, :n] = rng.integers(0, S, size=n)
    src[:, 1, 0] = 0  # state 1 reached from the start state
    logw = rng.normal(size=src.shape).astype(np.float32)
    ylocal = rng.normal(size=(B_, T_, S, K)).astype(np.float32)
    return torch.as_tensor(ylocal), torch.as_tensor(src), torch.as_tensor(logw)


@pytest.mark.parametrize("case", ["batch", "heavy"])
def test_k8f_order_over_the_list_matches_plain_and_pallas(sides, case):
    """The kernel's order over its by-destination list against
    e2e_forward_plain and the Pallas kernel in interpret mode, with the same
    -inf entries: on the e2e batch (runs of 0 to 3 arcs) and on tables with
    runs past E2E_HEAVY_RUN arcs."""
    if case == "batch":
        ylocal, src, logw, _ = _kernel_inputs(sides)
        src, logw = torch.as_tensor(src), torch.as_tensor(logw)
    else:
        ylocal, src, logw = _heavy_inputs()
    pre = tnr.e2e_kernel_tables(src, logw)
    assert (int(pre[2].diff(dim=1).max()) > tnr.E2E_HEAVY_RUN) == (case == "heavy")
    rest_e = emulate_e2e_forward(pre, ylocal)
    _assert_close_with_infs(rest_e.numpy(), tnr.e2e_forward_plain(ylocal, src, logw).numpy())
    rest_j = jnr.e2e_forward_resident(jnp.asarray(ylocal.numpy()), jnp.asarray(src.numpy()),
                                      jnp.asarray(logw.numpy()), interpret=True)
    _assert_close_with_infs(rest_e.numpy(), rest_j)


def test_k8b_order_over_the_staged_list_matches_plain_and_pallas(sides):
    """The kernel's order over its staged list against e2e_backward_plain
    and the Pallas kernel in interpret mode (TOL); sequence 1 impossible,
    sequence 2 with a NaN log_p: exact zeros, as on every pad slot."""
    ylocal, src, logw, final = _kernel_inputs(sides)
    src, logw = torch.as_tensor(src), torch.as_tensor(logw)
    rest = tnr.e2e_forward_plain(ylocal, src, logw)
    final = torch.as_tensor(final).clone()
    final[1] = -np.inf
    a0 = torch.full((1, B, src.shape[1]), -np.inf)
    a0[:, :, 0] = 0.0
    alphas = torch.cat([a0, rest[:-1]])
    log_p = torch.logsumexp(rest[-1] + final, dim=-1)
    assert torch.isneginf(log_p[1])
    log_p[2] = np.nan
    args = (ylocal, alphas, src, logw, final, log_p)
    post_e = emulate_e2e_backward(tnr.e2e_kernel_tables(src, logw), ylocal, alphas, final, log_p)
    post_p = tnr.e2e_backward_plain(*args)
    np.testing.assert_allclose(post_e.numpy(), post_p.numpy(), **TOL)
    assert (post_e[1:3] == 0).all() and (post_e[(src < 0)[:, None].expand_as(post_e)] == 0).all()
    post_j = jnr.e2e_backward_resident(*(jnp.asarray(x.numpy()) for x in args), interpret=True)
    np.testing.assert_allclose(post_e.numpy(), np.asarray(post_j), **TOL)


def test_invalid_sequence_zeroes_gamma(sides):
    """tests/test_e2e_supervision.py's case on the port: a sequence whose
    log_p is -inf gets exactly zero occupancies, the others stay finite."""
    yt = torch.as_tensor(sides["y"])
    lp, al = tne.e2e_forward(yt, sides["tsup"])
    bad = lp.clone()
    bad[0] = -np.inf
    g = tne.e2e_backward(yt, sides["tsup"], bad, al)
    assert (g[0] == 0).all() and torch.isfinite(g).all()
    np.testing.assert_allclose(g[1:].sum(-1).numpy(), 1.0, atol=1e-5)


def _brute_force_lists(src):
    """Each sequence's live slots of src [B, S, K] by destination (slot
    order) and by source, with their offsets, counted slot by slot."""
    B, S, K = src.shape
    out = []
    for b in range(B):
        flat = src[b].reshape(-1)
        by_dst = [[s * K + k for k in range(K) if src[b, s, k] >= 0] for s in range(S)]
        by_src = [[a for a in range(S * K) if flat[a] == s] for s in range(S)]
        out.append([(sum(x, []), np.cumsum([0] + [len(r) for r in x])) for x in (by_dst, by_src)])
    return out


def test_e2e_kernel_tables(sides):
    """The tables K8f/K8b read against lists counted slot by slot: the
    by-destination list holds every live slot once in slot order, with
    each destination's run offsets, and zeros after a short list; the
    by-source lists hold every live slot once, grouped by source in slot
    order.  Also a sequence without a live slot, a hole in a row (a live
    slot after a pad) and a sequence whose list is L long."""
    sup = sides["tb"].sup
    holed = np.full((3, 2, 4), -1)
    holed[1, 0, 1] = 0
    holed[2] = [[1, -1, 0, 1], [0, 0, -1, 1]]
    for src in (sup.in_src, holed):
        Bs, S, K = src.shape
        logw = np.random.default_rng(2).normal(size=src.shape).astype(np.float32)
        src32, logw32, in_off, in_arc, by_off, by_arc = tnr.e2e_kernel_tables(
            torch.as_tensor(src), torch.as_tensor(logw))
        assert src32.dtype == in_off.dtype == in_arc.dtype == torch.int32
        assert by_off.dtype == by_arc.dtype == torch.int32 and logw32.dtype == torch.float32
        assert torch.equal(src32.long(), torch.as_tensor(src).long())
        assert torch.equal(logw32, torch.as_tensor(logw))
        live = (src >= 0).reshape(Bs, -1).sum(1)
        L = max(1, int(live.max()))
        assert in_arc.shape == by_arc.shape == (Bs, L)
        for b, ((dst_list, dst_off), (src_list, src_off)) in enumerate(_brute_force_lists(src)):
            np.testing.assert_array_equal(in_off[b].numpy(), dst_off)
            np.testing.assert_array_equal(in_arc[b, :len(dst_list)].numpy(), dst_list)
            assert (in_arc[b, len(dst_list):] == 0).all()
            np.testing.assert_array_equal(by_off[b].numpy(), src_off)
            np.testing.assert_array_equal(by_arc[b, :len(src_list)].numpy(), src_list)
    assert in_off.tolist()[:2] == [[0, 0, 0], [0, 1, 1]] and in_arc[1, 0] == 1
    assert int(live[2]) == L == 6  # the list at L


@pytest.mark.parametrize("frame_weights", [False, True], ids=["plain", "frame_weights"])
@pytest.mark.parametrize("resident", ["0", "force"])
def test_chain_loss_e2e_matches_jax(sides, monkeypatch, resident, frame_weights):
    monkeypatch.setenv("TORCHAIN_NUM_RESIDENT", resident)
    jb, tb = sides["jb"].sup, sides["tb"].sup
    rng = np.random.default_rng(13)
    if frame_weights:
        fw = rng.random(size=(B, T)).astype(np.float32)
        jb, tb = (dataclasses.replace(s, frame_weights=fw) for s in (jb, tb))
    jsup = jne.DeviceE2eSupervision.from_host(jb)
    tsup = tne.DeviceE2eSupervision.from_host(tb, device="cpu").with_kernel_tables()
    jden = JResident.from_host(sides["jc"].den_graph, pad_to=8, dtype=jnp.float32)
    tden = tops.auto_den_graph(sides["tc"].den_graph, pad_to=8, device="cpu")
    y = sides["y"]
    x = rng.normal(size=y.shape).astype(np.float32)

    def jloss(y, x):
        return jops.chain_loss(y, x, jden, jsup, jops.ChainLossOptions(**OPTS))

    (l_j, aux_j), (dy_j, dx_j) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(y), jnp.asarray(x))
    yt = torch.tensor(y, requires_grad=True)
    xt = torch.tensor(x, requires_grad=True)
    l_t, aux_t = tops.chain_loss(yt, xt, tden, tsup, tops.ChainLossOptions(**OPTS))
    l_t.backward()
    np.testing.assert_allclose(float(l_t.detach()), float(l_j), rtol=1e-5)
    assert set(aux_t) == set(aux_j) and float(aux_t["num_failed"]) == 0.0
    for k in aux_j:
        np.testing.assert_allclose(float(aux_t[k].detach()), float(aux_j[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    np.testing.assert_allclose(yt.grad.numpy(), np.asarray(dy_j), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx_j), rtol=1e-4, atol=1e-6)


def test_device_e2e_supervision_moves_with_its_kernel_tables(sides):
    sup = sides["tsup"].with_kernel_tables().to("meta")
    assert sup.in_src.device.type == "meta"
    assert all(x.device.type == "meta" for x in sup.kernel_pre)
    assert sides["tsup"].kernel_pre is None
