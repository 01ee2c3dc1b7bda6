"""The port's ChainDataset egs surface against the JAX package's:
`save_egs`/`load_egs` round trips bit for bit; an archive written by
either package loads in the other (equal fingerprints); a mismatched
dataset is refused; dropped chunks survive a reload; `precompile(2)`
(forked workers) equals the serial compile; `batches(num_threads=3)`
equals `num_threads=0` batch for batch; the cache stops at its entry cap
and at its byte budget."""

import numpy as np
import pytest

pytest.importorskip("jax")

from torchain_tpu.data import ChainDataset as JChainDataset
from torchain_tpu.data import synthetic_dataset as j_synth
from torchain_tpu.graphs import SupervisionOptions as JSupOpts
from torchain_tpu_torch.data import ChainDataset, synthetic_dataset
from torchain_tpu_torch.graphs import SupervisionOptions

CORPUS = dict(num_utts=6, num_phones=5, feat_dim=6, utt_frames_out=(20, 26), seed=0)
SUP_FIELDS = ("in_src", "in_pdf", "in_logw", "final_logw", "num_states", "frame_vocab",
              "pdf_local")


def _make(tol=1, pkg="torch"):
    synth, ds_cls, opts = ((synthetic_dataset, ChainDataset, SupervisionOptions)
                           if pkg == "torch" else (j_synth, JChainDataset, JSupOpts))
    corpus = synth(**CORPUS)
    return corpus, ds_cls(corpus.utts, corpus.tree, corpus.norm_fst, chunk_frames_out=8,
                          left_context=3, right_context=3,
                          sup_opts=opts(left_tolerance=tol, right_tolerance=tol))


def _same_sup(a, b):
    for f in SUP_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            np.testing.assert_array_equal(x, y, err_msg=f)
    for f in ("num_frames", "num_pdfs", "max_states", "max_arcs", "steady_need"):
        assert getattr(a, f) == getattr(b, f), f
    np.testing.assert_array_equal(np.asarray(a.weight), np.asarray(b.weight))


def _same_batches(xs, ys):
    xs, ys = list(xs), list(ys)
    assert len(xs) == len(ys) > 0
    for a, b in zip(xs, ys):
        np.testing.assert_array_equal(a.feats, b.feats)
        _same_sup(a.sup, b.sup)


def test_save_load_round_trip_bit_for_bit(tmp_path):
    _, ds = _make()
    path = tmp_path / "egs.npz"
    n = ds.save_egs(path)
    assert n == len(ds.chunks)
    _, ds2 = _make()
    assert ds2.load_egs(path) == n
    ds2._chunk_supervision = None  # the cache holds every chunk: no compile
    for i in range(len(ds.chunks)):
        _same_sup(ds._sup_cache[i], ds2._sup_cache[i])
    _same_batches(ds.batches(2, shuffle=False), ds2.batches(2, shuffle=False))


def test_chunks_hold_python_ints_and_the_fingerprints_agree():
    _, ds = _make()
    _, jds = _make(pkg="jax")
    assert ds.chunks == jds.chunks
    for c in ds.chunks:
        ui, c0, t, ali, lc, rc = c
        assert all(type(v) is int for v in (ui, c0, t, lc, rc))
        assert all(type(p) is int and type(d) is int for p, d in ali)
    assert repr(ds.sup_opts) == repr(jds.sup_opts)
    assert ds.egs_fingerprint() == jds.egs_fingerprint()


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_an_archive_loads_in_the_other_package(tmp_path, writer):
    _, ds = _make()
    _, jds = _make(pkg="jax")
    path = tmp_path / "egs.npz"
    src, dst = (ds, jds) if writer == "torch" else (jds, ds)
    n = src.save_egs(path)
    assert dst.load_egs(path) == n == len(ds.chunks)
    for i in range(len(ds.chunks)):
        _same_sup(src._sup_cache[i], dst._sup_cache[i])


def test_load_refuses_a_mismatched_dataset(tmp_path):
    _, ds = _make(tol=1)
    path = tmp_path / "egs.npz"
    ds.save_egs(path)
    _, other = _make(tol=2)
    assert other.egs_fingerprint() != ds.egs_fingerprint()
    with pytest.raises(ValueError, match="fingerprint"):
        other.load_egs(path)


def test_fingerprint_follows_the_normalization_fst():
    from torchain_tpu_torch.fstkit import Fst

    corpus, ds = _make()
    bent = Fst()
    for _ in range(corpus.norm_fst.num_states):
        bent.add_state()
    for s in range(corpus.norm_fst.num_states):
        for a in corpus.norm_fst.arcs(s):
            bent.add_arc(s, a.label, a.weight + 0.125, a.dst)
        if corpus.norm_fst.is_final(s):
            bent.set_final(s, corpus.norm_fst.final(s))
    other = ChainDataset(corpus.utts, corpus.tree, bent, chunk_frames_out=8, left_context=3,
                         right_context=3,
                         sup_opts=SupervisionOptions(left_tolerance=1, right_tolerance=1))
    assert other.egs_fingerprint() != ds.egs_fingerprint()


def test_dropped_chunks_survive_a_reload(tmp_path):
    _, ds = _make()
    ds._sup_cache[0] = None  # a chunk whose compile failed
    path = tmp_path / "egs.npz"
    n = ds.save_egs(path)
    _, ds2 = _make()
    ds2.load_egs(path)
    assert ds2._sup_cache[0] is None
    assert len(ds2._sup_cache) == len(ds.chunks) and n == len(ds.chunks) - 1


def test_an_archive_without_the_numerator_tables_derives_them(tmp_path):
    """The legacy branch of load_egs: an archive of the five base fields
    alone loads to the same supervisions."""
    _, ds = _make()
    path = tmp_path / "egs.npz"
    ds.save_egs(path)
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files
                  if not k.endswith(("_frame_vocab", "_pdf_local"))}
    for k in list(arrays):
        if k.endswith("_meta"):
            arrays[k] = arrays[k][:4]
    legacy = tmp_path / "legacy.npz"
    np.savez_compressed(legacy, **arrays)
    _, ds2 = _make()
    ds2.load_egs(legacy)
    for i in range(len(ds.chunks)):
        _same_sup(ds._sup_cache[i], ds2._sup_cache[i])


def test_precompile_in_forked_workers_equals_the_serial_compile():
    _, serial = _make()
    _, forked = _make()
    assert forked.precompile(num_workers=2) == len(forked.chunks)
    assert forked.precompile(num_workers=2) == 0  # everything is cached
    forked._chunk_supervision = None
    for i in range(len(serial.chunks)):
        _same_sup(serial._sup_of(i), forked._sup_cache[i])
    assert forked.num_dropped == serial.num_dropped == 0
    _, one = _make()
    assert one.precompile(num_workers=1) == len(one.chunks)


def test_a_pickled_dataset_gets_a_fresh_lock():
    import pickle
    import threading

    _, ds = _make()
    back = pickle.loads(pickle.dumps(ds))
    assert isinstance(back._stats_lock, type(threading.Lock()))
    assert back._stats_lock is not ds._stats_lock and back.chunks == ds.chunks


@pytest.mark.parametrize("epoch", [0, 3])
def test_threaded_batches_equal_the_serial_ones(epoch):
    corpus = synthetic_dataset(num_utts=12, num_phones=5, feat_dim=8, seed=11)
    ds = ChainDataset(corpus.utts, corpus.tree, corpus.norm_fst, chunk_frames_out=12,
                      left_context=6, right_context=6,
                      sup_opts=SupervisionOptions(frame_subsampling_factor=3), seed=5)
    caps = ds.estimate_sup_caps()
    _same_batches(ds.batches(3, epoch=epoch, sup_caps=caps, num_threads=0),
                  ds.batches(3, epoch=epoch, sup_caps=caps, num_threads=3))
    # and the JAX package's batches, in order
    jcorpus = j_synth(num_utts=12, num_phones=5, feat_dim=8, seed=11)
    jds = JChainDataset(jcorpus.utts, jcorpus.tree, jcorpus.norm_fst, chunk_frames_out=12,
                        left_context=6, right_context=6,
                        sup_opts=JSupOpts(frame_subsampling_factor=3), seed=5)
    got = list(ds.batches(3, epoch=epoch, sup_caps=caps, num_threads=3))
    want = list(jds.batches(3, epoch=epoch, sup_caps=caps, num_threads=3))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.feats, b.feats)
        np.testing.assert_array_equal(a.sup.in_src, b.sup.in_src)


def test_the_cache_stops_at_its_entry_cap_and_byte_budget():
    _, ds = _make()
    one = ds._sup_nbytes(ds._chunk_supervision(*ds.chunks[0][3:5], ds.chunks[0][5]))
    assert one > 0
    ds.sup_cache_max_bytes = 2 * one + one // 2
    for i in range(len(ds.chunks)):
        ds._sup_of(i)
    assert 1 <= len(ds._sup_cache) < len(ds.chunks)
    assert ds._sup_cache_bytes <= ds.sup_cache_max_bytes
    assert ds._sup_cache_bytes == sum(ds._sup_nbytes(s) for s in ds._sup_cache.values())
    _, capped = _make()
    capped.sup_cache_size = 2
    for _ in capped.batches(2, epoch=0):
        pass
    assert len(capped._sup_cache) == 2
    # a full cache still serves every batch: misses compile again
    _same_batches(capped.batches(2, shuffle=False), _make()[1].batches(2, shuffle=False))


def test_threaded_builders_count_drops_and_bytes_under_the_lock(monkeypatch):
    """A stress test of the threaded batch builder: as many threads as
    cores, a switch interval of 1 µs, an empty cache and every third chunk
    failing to compile.  A lost update would break the drop count or the
    cache's byte count."""
    import os
    import sys

    corpus = synthetic_dataset(num_utts=24, num_phones=5, feat_dim=4, seed=3)
    ds = ChainDataset(corpus.utts, corpus.tree, corpus.norm_fst, chunk_frames_out=6,
                      left_context=1, right_context=1)
    from torchain_tpu_torch.data import loader

    orig = loader.alignment_to_supervision_fst
    failing = {id(c[3]) for c in ds.chunks[::3]}

    def flaky(ali, *a, **k):
        if id(ali) in failing:
            raise ValueError("a chunk that cannot be compiled")
        return orig(ali, *a, **k)

    monkeypatch.setattr(loader, "alignment_to_supervision_fst", flaky)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        got = list(ds.batches(2, epoch=0, drop_last=False, num_threads=os.cpu_count() or 2))
    finally:
        sys.setswitchinterval(old)
    assert got
    assert len(ds._sup_cache) == len(ds.chunks)
    assert ds.num_dropped == sum(s is None for s in ds._sup_cache.values()) == len(failing)
    assert ds._sup_cache_bytes == sum(ds._sup_nbytes(s) for s in ds._sup_cache.values())
