"""Resident numerator of the PyTorch port (ops/num_resident.py): the plain
versions of kernels K3 (`steady_forward`) and K4 (`steady_backward`), and
the wrappers on CPU tensors with and without placed tables, against the JAX
package's Pallas kernels in interpret mode on the same steady tables,
emissions and alpha of frame 1.

Tolerance: alpha and beta rtol 1e-5 + atol 1e-5 where finite, with the same
-inf entries; occupancies atol 1e-5 (float32 log-sum-exps of a few terms
per state, reduced in another order).  The impossible sequence (no final
state) has exactly zero occupancies on both sides."""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp
import torch

import torchain_tpu.data as jdata
import torchain_tpu.graphs as jgraphs
import torchain_tpu_torch.data as tdata
import torchain_tpu_torch.graphs as tgraphs
from torchain_tpu.ops import num_resident as jnr
from torchain_tpu.ops.device_graphs import DeviceSupervision as JSup
from torchain_tpu_torch.ops import num_resident as tnr
from torchain_tpu_torch.ops.device_graphs import DeviceSupervision as TSup

CORPORA = {
    "monophone_bigram": dict(num_utts=6, num_phones=4, feat_dim=8, utt_frames_out=(8, 11),
                             seed=5),
    "biphone_4gram": dict(num_utts=8, num_phones=5, feat_dim=8, utt_frames_out=(8, 11),
                          seed=3, context_width=2, lm_order=4, lm_extra_states=40),
}
BAD = 1  # the sequence made impossible


def _batch(pkg_data, pkg_graphs, corpus, B=4, T=8):
    c = pkg_data.synthetic_dataset(**corpus)
    ds = pkg_data.ChainDataset(
        c.utts, c.tree, c.norm_fst, chunk_frames_out=T, left_context=2,
        right_context=2,
        sup_opts=pkg_graphs.SupervisionOptions(left_tolerance=2, right_tolerance=2),
    )
    sup = next(ds.batches(B, shuffle=False)).sup
    sup.final_logw = sup.final_logw.copy()
    sup.final_logw[BAD] = -np.inf
    return sup


@pytest.fixture(scope="module", params=sorted(CORPORA))
def setup(request):
    corpus = CORPORA[request.param]
    jsup = JSup.from_host(_batch(jdata, jgraphs, corpus)).with_kernel_tables()
    tsup = TSup.from_host(_batch(tdata, tgraphs, corpus), device="cpu").with_kernel_tables()
    B, T, W = tsup.frame_vocab.shape
    ysmall = np.random.default_rng(7).normal(size=(B, T, W)).astype(np.float32)
    a0 = torch.full((B, tsup.max_states), -np.inf)
    a0[:, 0] = 0.0
    alpha1 = tnr.forward_step(
        a0, torch.as_tensor(ysmall[:, 0]), tsup.in_src0, tsup.pdf_local0, tsup.in_logw0
    ).numpy()
    return jsup, tsup, ysmall, alpha1


def _same_where_finite(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    assert fin.any() and not np.isnan(got).any()
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5, atol=1e-5)


def _torch_forward(how, tsup, ysm, alpha1):
    args = (torch.as_tensor(alpha1), tsup.in_src_r, tsup.pdf_local_r, tsup.in_logw_r, ysm)
    if how == "plain":
        return tnr.steady_forward_plain(*args)
    return tnr.steady_forward(*args, pre=tsup.kernel_pre if how == "wrapper_pre" else None)


def _torch_backward(how, tsup, ysm, alphas, log_p):
    args = (tsup.in_src_r, tsup.pdf_local_r, tsup.in_logw_r, ysm, alphas,
            tsup.final_logw, log_p)
    if how == "plain":
        return tnr.steady_backward_plain(*args)
    return tnr.steady_backward(*args, pre=tsup.kernel_pre if how == "wrapper_pre" else None)


HOW = ["plain", "wrapper", "wrapper_pre"]


@pytest.mark.parametrize("how", HOW)
def test_steady_forward_matches_pallas(setup, how):
    jsup, tsup, ysmall, alpha1 = setup
    aT_j, rest_j = jnr.steady_forward(
        jnp.asarray(alpha1), jsup.in_src_r, jsup.pdf_local_r, jsup.in_logw_r,
        jnp.asarray(ysmall[:, 1:]), interpret=True,
        pre=(jsup.src_k, jsup.pdf_local_k, jsup.logw_k) if how == "wrapper_pre" else None,
    )
    n = tnr.steady_forward.launches
    aT_t, rest_t = _torch_forward(how, tsup, torch.as_tensor(ysmall)[:, 1:], alpha1)
    assert rest_t.shape == (ysmall.shape[1] - 1,) + alpha1.shape
    _same_where_finite(rest_t, rest_j)
    _same_where_finite(aT_t, aT_j)
    assert torch.equal(aT_t, rest_t[-1])
    # on a CPU tensor no kernel is launched
    assert tnr.steady_forward.launches == n


@pytest.mark.parametrize("how", HOW)
def test_steady_backward_matches_pallas(setup, how):
    jsup, tsup, ysmall, alpha1 = setup
    ysm = torch.as_tensor(ysmall)[:, 1:]
    aT, rest = tnr.steady_forward_plain(
        torch.as_tensor(alpha1), tsup.in_src_r, tsup.pdf_local_r, tsup.in_logw_r, ysm
    )
    # alphas of the source frames 1..T-1: alpha1 and all but the last of rest
    alphas = torch.cat([torch.as_tensor(alpha1)[None], rest[:-1]])
    log_p = torch.logsumexp(aT + tsup.final_logw, dim=-1)
    assert torch.isneginf(log_p[BAD]) and torch.isfinite(log_p).sum() == len(log_p) - 1
    beta1_j, gsm_j = jnr.steady_backward(
        jsup.in_src_r, jsup.pdf_local_r, jsup.in_logw_r, jnp.asarray(ysmall[:, 1:]),
        jnp.asarray(alphas.numpy()), jsup.final_logw, jnp.asarray(log_p.numpy()),
        interpret=True,
        pre=(jsup.src_k, jsup.pdf_local_k, jsup.logw_k) if how == "wrapper_pre" else None,
    )
    n = tnr.steady_backward.launches
    beta1_t, gsm_t = _torch_backward(how, tsup, ysm, alphas, log_p)
    assert gsm_t.shape == (ysmall.shape[1] - 1, ysmall.shape[0], ysmall.shape[2])
    _same_where_finite(beta1_t, beta1_j)
    np.testing.assert_allclose(gsm_t.numpy(), np.asarray(gsm_j), atol=1e-5)
    assert (gsm_t[:, BAD] == 0).all() and (np.asarray(gsm_j)[:, BAD] == 0).all()
    ok = torch.isfinite(log_p)
    # valid sequences: every steady frame's occupancies sum to one
    np.testing.assert_allclose(gsm_t[:, ok].sum(-1).numpy(), 1.0, atol=1e-5)
    assert tnr.steady_backward.launches == n


def test_kernel_tables_hold_the_same_values_in_the_kernels_types(setup):
    """The placed batch carries what K3 and K4 read and nothing else: the
    live list's per-frame offsets, its records and its per-frame
    destination offsets, int32 and contiguous; the records hold the dense
    tables' values (src, dst, lpdf, logw's bits)."""
    _, tsup, _, _ = setup
    bare = dataclasses.replace(tsup, arc_off_k=None, arcs_k=None, dst_off_k=None)
    assert bare.kernel_pre is None
    arc_off, arcs, dst_off = tsup.kernel_pre
    B, Tm1, S, Kr = tsup.in_src_r.shape
    for k, shape in ((arc_off, (B, Tm1 + 1)), (arcs, (B, arcs.shape[1], 4)),
                     (dst_off, (B, Tm1, S + 1))):
        assert k.dtype == torch.int32 and k.is_contiguous() and k.shape == shape
    live = tsup.in_src_r >= 0
    rec = torch.cat([arcs[b, :int(arc_off[b, -1])] for b in range(B)])
    assert torch.equal(rec[:, 0].long(), tsup.in_src_r[live])
    assert torch.equal(rec[:, 2].long(), tsup.pdf_local_r[live])
    assert torch.equal(rec[:, 3].view(torch.float32), tsup.in_logw_r[live])
    # the int64 tables of the plain path stay
    assert tsup.in_src_r.dtype == torch.int64 and tsup.pdf_local_r.dtype == torch.int64


def _expected_list(src, lpdf, logw):
    """The live slots of dense [B, T-1, S, Kr] tables (numpy), per sequence
    frame by frame in slot order, as (src, dst, lpdf, logw) rows, and the
    per-frame offsets."""
    B, Tm1, S, Kr = src.shape
    lists, offs = [], []
    for b in range(B):
        rows, off = [], [0]
        for t in range(Tm1):
            slots = np.flatnonzero(src[b, t].reshape(-1) >= 0)
            for i in slots:
                s, k = divmod(int(i), Kr)
                rows.append((src[b, t, s, k], s, lpdf[b, t, s, k], logw[b, t, s, k]))
            off.append(off[-1] + len(slots))
        lists.append(rows)
        offs.append(off)
    return lists, np.asarray(offs)


def _expected_dst_off(src):
    """Where each destination state's run of each frame starts in its
    sequence's list of live slots, counted slot by slot, and one past the
    frame's last: [B, T-1, S+1]."""
    B, Tm1, S, Kr = src.shape
    out = np.zeros((B, Tm1, S + 1), dtype=np.int64)
    for b in range(B):
        n = 0
        for t in range(Tm1):
            for s in range(S):
                out[b, t, s] = n
                n += int((src[b, t, s] >= 0).sum())
            out[b, t, S] = n
    return out


def _assert_list(pre, src, lpdf, logw):
    """The list in `pre` holds every live slot of the dense tables, in slot
    order, with the right per-frame offsets (K4) and destination offsets
    (K3), and zeros after a short list."""
    arc_off, arcs, dst_off = pre
    src, lpdf, logw = (np.asarray(x) for x in (src, lpdf, logw))
    lists, offs = _expected_list(src, lpdf, logw)
    assert arc_off.dtype == arcs.dtype == dst_off.dtype == torch.int32
    assert arc_off.is_contiguous() and arcs.is_contiguous() and dst_off.is_contiguous()
    np.testing.assert_array_equal(arc_off.numpy(), offs)
    np.testing.assert_array_equal(dst_off.numpy(), _expected_dst_off(src))
    L = max(1, max(len(x) for x in lists))
    assert arcs.shape == (src.shape[0], L, 4)
    for b, rows in enumerate(lists):
        got = arcs[b].numpy()
        n = len(rows)
        if n:
            want = np.asarray(rows)
            np.testing.assert_array_equal(got[:n, :3], want[:, :3].astype(np.int32))
            np.testing.assert_array_equal(got[:n, 3].view(np.float32),
                                          want[:, 3].astype(np.float32))
        assert (got[n:] == 0).all()


def _list_records(pre, b, t):
    """Frame t of sequence b in K4's list: src, dst, lpdf and logw."""
    arc_off, arcs, _ = pre
    rec = arcs[b, arc_off[b, t]:arc_off[b, t + 1]]
    return (*(rec[:, i].long() for i in range(3)), rec[:, 3].view(torch.float32))


def _dense_records(tables, b, t):
    """Frame t of sequence b as the dense design walked it: every slot,
    pads (src -1) included."""
    src, lpdf, logw = tables
    Kr = src.shape[-1]
    dst = torch.arange(src.shape[2]).repeat_interleave(Kr)
    return src[b, t].reshape(-1).long(), dst, lpdf[b, t].reshape(-1).long(), logw[b, t].reshape(-1)


def emulate_steady_backward(records, ysm, alphas, final_logw, log_p):
    """K4 as csrc/num_resident.cu computes it, over each frame's records
    (`records(b, t)`, K4's list or the dense slots): per frame, in reverse,
    arc_w and post for each record (-inf and 0 on a pad); then each source
    state scans the frame's records in order (maximum, then sum of exp, one
    float32 addition at a time) and each vocabulary slot sums the posteriors
    of its records the same way.  Elementwise values by torch's float32
    operations, as the plain version computes them."""
    B, Tm1, W = ysm.shape
    S = final_logw.shape[1]
    logp = torch.where(torch.isfinite(log_p), log_p, torch.inf)
    beta = final_logw.clone()
    gsm = torch.empty((Tm1, B, W))
    for b in range(B):
        for t in range(Tm1 - 1, -1, -1):
            src, dst, lpdf, lw = records(b, t)
            pad = src < 0
            aw = torch.where(pad, -torch.inf, (lw + ysm[b, t, lpdf]) + beta[b, dst])
            po = torch.where(pad, 0.0, torch.exp(alphas[t, b, src.clamp(min=0)] + aw - logp[b]))
            nxt = torch.full((S,), -torch.inf)
            for sp in range(S):
                mine = aw[src == sp]
                m = mine.max() if len(mine) else torch.tensor(-torch.inf)
                if m > -torch.inf:
                    acc = torch.tensor(0.0)
                    for v in torch.exp(mine - m):
                        acc = acc + v
                    nxt[sp] = m + torch.log(acc)
            for w in range(W):
                acc = torch.tensor(0.0)
                for v in po[lpdf == w]:
                    acc = acc + v
                gsm[t, b, w] = acc
            beta[b] = nxt
    return beta, gsm


def _backward_inputs(tsup, ysmall, alpha1):
    ysm = torch.as_tensor(ysmall)[:, 1:]
    aT, rest = tnr.steady_forward_plain(
        torch.as_tensor(alpha1), tsup.in_src_r, tsup.pdf_local_r, tsup.in_logw_r, ysm
    )
    alphas = torch.cat([torch.as_tensor(alpha1)[None], rest[:-1]])
    log_p = torch.logsumexp(aT + tsup.final_logw, dim=-1)
    return ysm, alphas, log_p


def test_live_arc_list_holds_every_live_slot_in_slot_order(setup):
    _, tsup, _, _ = setup
    _assert_list(tsup.kernel_pre, tsup.in_src_r, tsup.pdf_local_r, tsup.in_logw_r)
    # the placed tables are those `kernel_tables` makes from the dense ones
    rebuilt = tnr.kernel_tables(tsup.in_src_r, tsup.pdf_local_r, tsup.in_logw_r)
    for a, b in zip(rebuilt, tsup.kernel_pre):
        assert torch.equal(a, b)


def test_k4_order_over_the_list_matches_plain_and_pallas(setup):
    """The kernel's order over the list gives the plain version's bits: the
    list keeps slot order, and the dense design's pads only added +0.0.
    Against the JAX kernel in interpret mode within 1e-5."""
    jsup, tsup, ysmall, alpha1 = setup
    ysm, alphas, log_p = _backward_inputs(tsup, ysmall, alpha1)
    log_p[0] = float("nan")
    args = (ysm, alphas, tsup.final_logw, log_p)
    beta1_e, gsm_e = emulate_steady_backward(
        lambda b, t: _list_records(tsup.kernel_pre, b, t), *args)
    beta1_p, gsm_p = tnr.steady_backward_plain(
        tsup.in_src_r, tsup.pdf_local_r, tsup.in_logw_r, *args)
    assert torch.equal(beta1_e, beta1_p) and torch.equal(gsm_e, gsm_p)
    assert (gsm_e[:, 0] == 0).all() and (gsm_e[:, BAD] == 0).all()
    beta1_j, gsm_j = jnr.steady_backward(
        jsup.in_src_r, jsup.pdf_local_r, jsup.in_logw_r, jnp.asarray(ysmall[:, 1:]),
        jnp.asarray(alphas.numpy()), jsup.final_logw, jnp.asarray(log_p.numpy()),
        interpret=True,
    )
    _same_where_finite(beta1_e, beta1_j)
    np.testing.assert_allclose(gsm_e.numpy(), np.asarray(gsm_j), atol=1e-5)


def _edge_tables(Kr):
    """Dense steady tables (B=3, 5 frames, 6 states) with random live slots
    anywhere in a row, and at the edges: sequence 0's frame 1 without a
    live arc, sequence 1's frame 2 with all S * Kr slots live, sequence 2
    without a live arc at all."""
    rng = np.random.default_rng(Kr)
    B, Tm1, S, W = 3, 5, 6, 8
    live = rng.random(size=(B, Tm1, S, Kr)) < 0.4
    live[0, 1] = False
    live[1, 2] = True
    live[2] = False
    src = np.where(live, rng.integers(0, S, size=live.shape), -1)
    lpdf = np.where(live, rng.integers(0, W, size=live.shape), 0)
    logw = np.where(live, rng.normal(size=live.shape), 0.0).astype(np.float32)
    ysm = rng.normal(size=(B, Tm1, W)).astype(np.float32)
    alphas = np.where(rng.random(size=(Tm1, B, S)) < 0.2, -np.inf,
                      rng.normal(size=(Tm1, B, S))).astype(np.float32)
    final = np.where(rng.random(size=(B, S)) < 0.5, -np.inf, 0.0).astype(np.float32)
    final[:, 0] = 0.0
    log_p = rng.normal(size=B).astype(np.float32)
    log_p[2] = -np.inf
    t = torch.as_tensor
    return (t(src), t(lpdf), t(logw)), tuple(t(x) for x in (ysm, alphas, final, log_p))


@pytest.mark.parametrize("Kr", [4, 12], ids=["production_Kr4", "trigram_Kr12"])
def test_live_arc_list_at_the_edges(Kr):
    """A frame without a live arc, a frame with every slot live and a
    sequence with an empty list.  The kernel's order over the list gives
    the bits of the dense design's order over every slot (its pads only
    ever added +0.0 or were skipped).  Against the plain version: where a
    source state has many arcs in one frame, torch sums them in another
    grouping, so within the card's tolerances (beta 1e-5, gsm atol 1e-6 and
    rtol 1e-5; log_p here is not the sequences' own, so gsm is not bounded
    by 1)."""
    tables, args = _edge_tables(Kr)
    pre = tnr.kernel_tables(*tables)
    _assert_list(pre, *tables)
    arc_off, arcs, dst_off = pre
    assert arc_off[0, 2] == arc_off[0, 1]  # the empty frame
    assert (dst_off[0, 1] == arc_off[0, 1]).all()  # ... where every run is empty
    assert arc_off[1, 3] - arc_off[1, 2] == 6 * Kr  # the full frame
    assert (dst_off[1, 2].diff() == Kr).all()  # ... where every run is Kr long
    assert arc_off[2, -1] == 0 and (arcs[2] == 0).all()  # the empty list
    assert (dst_off[2] == 0).all()
    assert int(arc_off[:, -1].max()) == arcs.shape[1]  # one sequence's list is L long
    beta1_e, gsm_e = emulate_steady_backward(lambda b, t: _list_records(pre, b, t), *args)
    beta1_d, gsm_d = emulate_steady_backward(lambda b, t: _dense_records(tables, b, t), *args)
    assert torch.equal(beta1_e, beta1_d) and torch.equal(gsm_e, gsm_d)
    beta1_p, gsm_p = tnr.steady_backward_plain(*tables, *args)
    _same_where_finite(beta1_e, beta1_p)
    torch.testing.assert_close(gsm_e, gsm_p, atol=1e-6, rtol=1e-5)
    assert (gsm_e[:, 2] == 0).all()


def emulate_steady_forward(runs, alpha1, ysm):
    """K3 as csrc/num_resident.cu computes it, over each destination's run
    of each frame (`runs(b, t, s)`: src, lpdf, logw of its records, from
    the list by its destination offsets, or the dense slot row with its
    pads): v = alpha[src] + (logw + ysm[lpdf]) (-inf on a pad), the maximum,
    then the sum of exp(v - m) one float32 addition at a time in order, and
    m + log(sum), -inf where m is.  Returns alphas [T-1, B, S]."""
    B, Tm1, _ = ysm.shape
    S = alpha1.shape[1]
    alpha = alpha1.clone()
    out = torch.empty((Tm1, B, S))
    for t in range(Tm1):
        for b in range(B):
            for s in range(S):
                src, lpdf, lw = runs(b, t, s)
                v = torch.where(src < 0, -torch.inf,
                                alpha[b, src.clamp(min=0)] + (lw + ysm[b, t, lpdf]))
                m = v.max() if len(v) else torch.tensor(-torch.inf)
                r = torch.tensor(-torch.inf)
                if m > -torch.inf:
                    acc = torch.tensor(0.0)
                    for x in torch.exp(v - m):
                        acc = acc + x
                    r = m + torch.log(acc)
                out[t, b, s] = r
        alpha = out[t]
    return out


def _list_run(pre, b, t, s):
    """Destination s's run of frame t of sequence b in K3's list."""
    _, arcs, dst_off = pre
    rec = arcs[b, dst_off[b, t, s]:dst_off[b, t, s + 1]]
    assert (rec[:, 1] == s).all()
    return rec[:, 0].long(), rec[:, 2].long(), rec[:, 3].view(torch.float32)


def _dense_run(tables, b, t, s):
    src, lpdf, logw = tables
    return src[b, t, s].long(), lpdf[b, t, s].long(), logw[b, t, s]


@pytest.mark.parametrize("Kr", [4, 12, None], ids=["production_Kr4", "trigram_Kr12", "batch"])
def test_k3_order_over_the_runs_matches_the_dense_order(setup, Kr):
    """K3's walk of each destination's run gives the bits of the dense
    design's walk of every slot (its pads only ever added +0.0 or left the
    maximum as it was): on the edge tables (an empty frame, a full frame,
    an empty list) and on the placed batch.  Against the plain version (torch
    sums another way) and, on the batch, the JAX kernel in interpret mode
    within 1e-5."""
    jsup, tsup, ysmall, alpha1 = setup
    if Kr is None:
        tables = (tsup.in_src_r, tsup.pdf_local_r, tsup.in_logw_r)
        pre, ysm, a1 = tsup.kernel_pre, torch.as_tensor(ysmall)[:, 1:], torch.as_tensor(alpha1)
    else:
        tables, (ysm, alphas, _, _) = _edge_tables(Kr)
        pre, a1 = tnr.kernel_tables(*tables), alphas[0]
    got = emulate_steady_forward(lambda b, t, s: _list_run(pre, b, t, s), a1, ysm)
    want = emulate_steady_forward(lambda b, t, s: _dense_run(tables, b, t, s), a1, ysm)
    assert torch.equal(got, want)
    _same_where_finite(got, tnr.steady_forward_plain(a1, *tables, ysm)[1])
    if Kr is None:
        _, rest_j = jnr.steady_forward(
            jnp.asarray(alpha1), jsup.in_src_r, jsup.pdf_local_r, jsup.in_logw_r,
            jnp.asarray(ysmall[:, 1:]), interpret=True)
        _same_where_finite(got, rest_j)


def test_device_supervision_moves_with_its_live_arc_list(setup):
    _, tsup, _, _ = setup
    moved = tsup.to("meta")
    assert moved.arc_off_k.device.type == moved.arcs_k.device.type == "meta"
    assert all(x.device.type == "meta" for x in moved.kernel_pre)
    assert len(moved.kernel_pre) == 3
    bare = dataclasses.replace(tsup, arc_off_k=None, arcs_k=None, dst_off_k=None)
    assert bare.to("meta").kernel_pre is None


def test_no_steady_frames_is_the_identity(setup):
    """T = 1: no steady frame, so alpha and beta pass through unchanged."""
    _, tsup, ysmall, alpha1 = setup
    B, _, W = ysmall.shape
    S = tsup.max_states
    none = (tsup.in_src_r[:, :0], tsup.pdf_local_r[:, :0], tsup.in_logw_r[:, :0])
    ysm = torch.as_tensor(ysmall)[:, 1:1]
    a1 = torch.as_tensor(alpha1)
    aT, rest = tnr.steady_forward(a1, *none, ysm)
    assert torch.equal(aT, a1) and rest.shape == (0, B, S)
    beta1, gsm = tnr.steady_backward(*none, ysm, rest, tsup.final_logw, torch.zeros(B))
    assert torch.equal(beta1, tsup.final_logw) and gsm.shape == (0, B, W)


def test_non_finite_log_p_of_any_kind_zeroes_the_occupancies(setup):
    """A NaN log_p (a numeric failure upstream) is contained like -inf."""
    _, tsup, ysmall, alpha1 = setup
    ysm = torch.as_tensor(ysmall)[:, 1:]
    aT, rest = tnr.steady_forward(
        torch.as_tensor(alpha1), tsup.in_src_r, tsup.pdf_local_r, tsup.in_logw_r, ysm
    )
    alphas = torch.cat([torch.as_tensor(alpha1)[None], rest[:-1]])
    log_p = torch.logsumexp(aT + tsup.final_logw, dim=-1)
    log_p[0] = float("nan")
    _, gsm = tnr.steady_backward(
        tsup.in_src_r, tsup.pdf_local_r, tsup.in_logw_r, ysm, alphas, tsup.final_logw, log_p
    )
    assert (gsm[:, 0] == 0).all() and (gsm[:, BAD] == 0).all()
    assert torch.isfinite(gsm).all() and (gsm[:, 2].sum(-1) > 0.99).all()
