"""Host layers of the PyTorch port (fstkit, graphs, data, DeviceSupervision,
the resident denominator packing) against the JAX package.

The host layers are numpy code copied into the port, so for the same
arguments and seed every array must be IDENTICAL: compared exactly."""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")

import torch

import torchain_tpu.data as jdata
import torchain_tpu.graphs as jgraphs
import torchain_tpu.ops.device_graphs as jdg
import torchain_tpu_torch.data as tdata
import torchain_tpu_torch.graphs as tgraphs
import torchain_tpu_torch.ops.device_graphs as tdg
import torchain_tpu_torch.ops.num_resident as tnr
from torchain_tpu.ops.den_resident import DeviceResidentDenGraph as JResident
from torchain_tpu_torch.ops.den_resident import DeviceResidentDenGraph as TResident


def _as_np(v):
    if isinstance(v, torch.Tensor):
        return v.cpu().numpy()
    if hasattr(v, "__array__") and not isinstance(v, np.ndarray):
        return np.asarray(v)
    return v


def _assert_same(a, b, what):
    a, b = _as_np(a), _as_np(b)
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert np.shape(a) == np.shape(b), what
        np.testing.assert_array_equal(
            np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64),
            err_msg=what,
        )
    else:
        assert a == b, what


def _assert_same_fields(ja, ta, skip=()):
    for f in dataclasses.fields(ja):
        if f.name in skip:
            continue
        _assert_same(getattr(ja, f.name), getattr(ta, f.name), f.name)


def _fst_arcs(fst):
    return (
        fst.num_states,
        [(s, a.label, a.weight, a.dst) for s, a in fst.all_arcs()],
        [fst.final(s) for s in range(fst.num_states)],
    )


CORPORA = {
    # the bench's kind of graph, cut down: bigram, monophone
    "bigram": dict(num_utts=6, num_phones=4, feat_dim=8, utt_frames_out=(8, 11),
                   seed=3, lm_order=2, lm_extra_states=20),
    # trigram with the left-biphone expansion of the production config
    "trigram_biphone": dict(num_utts=6, num_phones=4, feat_dim=8,
                            utt_frames_out=(8, 11), seed=4, lm_order=3,
                            lm_extra_states=30, context_width=2),
}


@pytest.fixture(scope="module", params=sorted(CORPORA))
def corpora(request):
    kw = CORPORA[request.param]
    return jdata.synthetic_dataset(**kw), tdata.synthetic_dataset(**kw)


def _datasets(jc, tc, T_out=8):
    kw = dict(chunk_frames_out=T_out, left_context=4, right_context=4,
              sup_opts=jgraphs.SupervisionOptions(left_tolerance=2, right_tolerance=2))
    jd = jdata.ChainDataset(jc.utts, jc.tree, jc.norm_fst, **kw)
    kw["sup_opts"] = tgraphs.SupervisionOptions(left_tolerance=2, right_tolerance=2)
    td = tdata.ChainDataset(tc.utts, tc.tree, tc.norm_fst, **kw)
    return jd, td


def test_corpus_and_graphs_identical(corpora):
    jc, tc = corpora
    assert len(jc.utts) == len(tc.utts)
    for ju, tu in zip(jc.utts, tc.utts):
        np.testing.assert_array_equal(ju.feats, tu.feats)
        assert ju.alignment == tu.alignment and ju.utt_id == tu.utt_id
    np.testing.assert_array_equal(jc.pdf_means, tc.pdf_means)
    assert jc.tree.num_pdfs == tc.tree.num_pdfs
    assert _fst_arcs(jc.phone_lm) == _fst_arcs(tc.phone_lm)
    assert _fst_arcs(jc.den_fst) == _fst_arcs(tc.den_fst)
    assert _fst_arcs(jc.norm_fst) == _fst_arcs(tc.norm_fst)
    _assert_same_fields(jc.den_graph, tc.den_graph)


def test_batches_and_device_supervision_identical(corpora):
    jc, tc = corpora
    jd, td = _datasets(jc, tc)
    jbs = list(jd.batches(2, shuffle=True, epoch=1))
    tbs = list(td.batches(2, shuffle=True, epoch=1))
    assert len(jbs) == len(tbs) > 0
    for jb, tb in zip(jbs, tbs):
        np.testing.assert_array_equal(jb.feats, tb.feats)
        _assert_same_fields(jb.sup, tb.sup)
        jsup = jdg.DeviceSupervision.from_host(jb.sup).with_kernel_tables()
        tsup = tdg.DeviceSupervision.from_host(tb.sup, device="cpu").with_kernel_tables()
        # index dtypes differ (int16 there, int64 here); values may not
        kernel = ("src_k", "pdf_local_k", "logw_k")
        _assert_same_fields(jsup, tsup, skip=kernel)
        # the tables prepared for the steady-frame kernels hold the same
        # arcs in each package's own layout: dense [T-1, Kr, S, B] tables
        # for the TPU's lanes there, each sequence's list of live arcs (one
        # thread block per sequence) here, which the dense tables list alike
        dense = [np.transpose(np.array(getattr(jsup, name)), (3, 0, 2, 1)) for name in kernel]
        want = tnr.kernel_tables(*(torch.as_tensor(x) for x in dense))
        for name, a, b in zip(("arc_off_k", "arcs_k", "dst_off_k"), want, tsup.kernel_pre):
            _assert_same(a, b, name)
    assert jd.num_dropped == td.num_dropped


def test_frame_vocab_helpers_identical():
    rng = np.random.default_rng(0)
    in_src = rng.integers(-1, 5, size=(2, 3, 5, 4)).astype(np.int32)
    in_pdf = rng.integers(0, 9, size=(2, 3, 5, 4)).astype(np.int32)
    for kw in ({}, {"pad_to": 24}, {"round_to": 1}):
        j = jdg._frame_vocab_tables(in_src, in_pdf, **kw)
        t = tdg._frame_vocab_tables(in_src, in_pdf, **kw)
        for a, b in zip(j, t):
            np.testing.assert_array_equal(a, b)
    assert jdg.frame_vocab_width(in_src, in_pdf) == tdg.frame_vocab_width(in_src, in_pdf)


@pytest.mark.parametrize("pad_to", [8, 128])
def test_resident_packing_identical(corpora, pad_to):
    jc, tc = corpora
    import jax.numpy as jnp

    jr = JResident.from_host(jc.den_graph, pad_to=pad_to, dtype=jnp.float32)
    tr = TResident.from_host(tc.den_graph, pad_to=pad_to, device="cpu")
    assert (jr.num_states, jr.real_states, jr.num_slots, jr.num_pdfs) == (
        tr.num_states, tr.real_states, tr.num_slots, tr.num_pdfs)
    np.testing.assert_array_equal(np.asarray(jr.V), tr.V.numpy())
    np.testing.assert_array_equal(np.asarray(jr.init)[0], tr.init.numpy())
    # dead slots: pdf 0 with a zero one-hot row there, -1 here
    onehot = np.asarray(jr.slot_onehot)
    live = onehot.sum(1) > 0
    slot_pdf = tr.slot_pdf.numpy()
    np.testing.assert_array_equal(slot_pdf >= 0, live)
    np.testing.assert_array_equal(slot_pdf[live], np.asarray(jr.slot_pdf)[live])
    # the per-pdf CSR lists exactly the one-hot's live slots of each pdf
    off, slots = tr.pdf_offsets.numpy(), tr.pdf_slots.numpy()
    for q in range(tr.num_pdfs):
        got = np.sort(slots[off[q]:off[q + 1]])
        np.testing.assert_array_equal(got, np.flatnonzero(onehot[:, q]))
