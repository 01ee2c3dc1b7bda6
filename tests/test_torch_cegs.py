"""The port's merged Kaldi cegs archives (data/cegs.py) and egs CLI
(cli/egs.py) against the JAX package's, on the same seeded inputs.

Writers: the same bytes (index vectors, standard and e2e supervisions,
examples with and without compression, archives and their .scp offsets,
`dataset_to_cegs`, every `cli.egs` subcommand), and the port's writer
reproduces tests/fixtures/golden_cegs.ark.  Readers and batches: every
field of the resulting Supervision / E2eSupervision equal to the JAX
package's, integers and floats exactly, with ivectors, online ivectors,
non-unit deriv_weights (both stored forms) and sup_caps; CegsDataset's
shuffle order per (seed, epoch), process sharding and caps likewise.
Merge and split are exact inverses (the same label sequences, each
weighing the same to 1e-6)
and give the JAX package's FSTs.

Loss and step: the chain loss of a cegs batch against the JAX chain_loss
(resident denominator, Pallas kernels in interpret mode) at
tests/test_torch_chain_loss.py's tolerances (rtol 1e-5 on the scalars,
rtol 1e-4 / atol 1e-6 on the gradients), standard and e2e records, with
and without frame weights; one train step of a 2-layer TDNN-F from a Kaldi
prep (merged cegs + binary den.fst) from the same parameters
(convert.params_from_jax) at tests/test_torch_train.py's float32 rtol of
1e-4 on every metric."""

import contextlib
import dataclasses
import io
import pathlib
import struct

import numpy as np
import pytest

pytest.importorskip("jax")

import torchain_tpu.data.cegs as jc
import torchain_tpu.fstkit as jf
import torchain_tpu.graphs as jg
import torchain_tpu_torch.data.cegs as tc
import torchain_tpu_torch.fstkit as tf
import torchain_tpu_torch.graphs as tg
from tests.test_torch_openfst import assert_same_fst

FIXTURES = pathlib.Path(__file__).parent / "fixtures"
SIDES = (("t", tc, tf, tg), ("j", jc, jf, jg))


def setup_chunks(fk, gk, num_chunks=3, T=6, seed=0, normalize=True):
    """tests/test_cegs.py's setup_chunks over package (fk, gk): per-sequence
    supervision FSTs (normalization-composed, as get-egs stores them), the
    den graph, the tree and the normalization FST."""
    rng = np.random.default_rng(seed)
    num_phones = 3
    sents = [
        [int(x) for x in rng.integers(1, num_phones + 1, size=rng.integers(2, 6))]
        for _ in range(30)
    ]
    lm = gk.estimate_phone_lm(sents, gk.PhoneLmOptions(ngram_order=2))
    tree = gk.ContextTree(num_phones, context_width=1)
    den_fst = gk.make_den_fst(lm, tree)
    graph = gk.compile_den_graph(den_fst, tree.num_pdfs)
    norm = gk.make_normalization_fst(den_fst, graph.initial_probs)
    opts = gk.SupervisionOptions(left_tolerance=1, right_tolerance=1)
    chunks = []
    for _ in range(num_chunks):
        while True:
            n_seg = int(rng.integers(2, 4))
            phones = rng.integers(1, num_phones + 1, size=n_seg)
            durs = rng.multinomial(T - n_seg, np.ones(n_seg) / n_seg) + 1
            ali = [(int(p), int(d)) for p, d in zip(phones, durs)]
            fst = gk.alignment_to_supervision_fst(ali, tree, opts)
            if normalize:
                fst = fk.compose(fst, norm)
            if fst.num_states:
                break
        chunks.append(fst)
    return chunks, tree, graph, norm, den_fst


def e2e_fsts(gk, tree, norm, B, seed):
    rng = np.random.default_rng(seed)
    out = []
    while len(out) < B:
        phones = [int(p) for p in rng.integers(1, 4, size=int(rng.integers(2, 4)))]
        try:
            out.append(gk.make_e2e_supervision_fst(phones, tree, norm))
        except ValueError:
            continue
    return out


def make_example(side, B=3, T=6, seed=5, ivector=False, e2e=False):
    """The same seeded example built by one package end to end."""
    _, ck, fk, gk = side
    chunks, tree, graph, norm, _ = setup_chunks(fk, gk, num_chunks=B, T=T, seed=seed,
                                                normalize=not e2e)
    rng = np.random.default_rng(seed + 1)
    feats = rng.standard_normal((B, T * 3 + 6, 8)).astype(np.float32)
    ivecs = rng.standard_normal((B, 5)).astype(np.float32) if ivector else None
    if e2e:
        return ck.make_e2e_chain_example(
            feats, e2e_fsts(gk, tree, norm, B, seed), label_dim=tree.num_pdfs,
            frames_per_sequence=T, frame_subsampling_factor=3, weight=0.75, left_context=2,
            ivectors=ivecs)
    return ck.make_chain_example(feats, chunks, label_dim=tree.num_pdfs,
                                 frame_subsampling_factor=3, left_context=2, ivectors=ivecs)


def eg_bytes(ck, eg, compress=False):
    buf = io.BytesIO()
    ck.write_chain_example(buf, eg, compress=compress)
    return buf.getvalue()


def assert_same_arrays(a, b, what=""):
    """Every dataclass field of two host supervisions (or batches) equal:
    arrays in dtype, shape and value, everything else by ==."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, what
        for f in dataclasses.fields(a):
            assert_same_arrays(getattr(a, f.name), getattr(b, f.name), f"{what}.{f.name}")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, what
        np.testing.assert_array_equal(a, b, err_msg=what)
    else:
        assert a == b, what


def assert_same_example(a, b):
    assert [i.name for i in a.inputs] == [i.name for i in b.inputs]
    for x, y in zip(a.inputs, b.inputs):
        assert x.indexes == y.indexes
        assert_same_arrays(x.features, y.features, x.name)
    for x, y in zip(a.outputs, b.outputs):
        assert (x.name, x.indexes) == (y.name, y.indexes)
        assert_same_arrays(x.deriv_weights, y.deriv_weights, "deriv_weights")
        sa, sb = x.supervision, y.supervision
        assert (sa.weight, sa.num_sequences, sa.frames_per_sequence, sa.label_dim, sa.is_e2e) == (
            sb.weight, sb.num_sequences, sb.frames_per_sequence, sb.label_dim, sb.is_e2e)
        for fa, fb in zip(sa.e2e_fsts or [sa.fst], sb.e2e_fsts or [sb.fst]):
            assert_same_fst(fa, fb)


# ---------------------------------------------------------------------------
# stream pieces and the golden fixture
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("indexes", [
    [(0, t, 0) for t in range(-3, 10)],
    [(n, t, 0) for n in range(3) for t in range(5)],
    [(0, 0, 0), (0, 200, 0), (1, -200, 0), (1, -199, 2)],
    [],
    [(0, -124, 0), (0, 0, 0), (0, 124, 0), (0, 125, 0)],
], ids=["run", "grid", "escapes", "empty", "limits"])
def test_index_vectors_give_the_same_bytes(indexes):
    bt, bj = io.BytesIO(), io.BytesIO()
    tc.write_index_vector(bt, indexes)
    jc.write_index_vector(bj, indexes)
    assert bt.getvalue() == bj.getvalue()
    assert tc.read_index_vector(io.BytesIO(bt.getvalue())) == indexes


@pytest.mark.parametrize("e2e", [False, True], ids=["standard", "e2e"])
def test_supervisions_give_the_same_bytes_and_read_alike(e2e):
    out = {}
    for side in SIDES:
        name, ck, fk, gk = side
        chunks, tree, _g, norm, _ = setup_chunks(fk, gk, num_chunks=2, normalize=not e2e)
        sup = ck.KaldiSupervision(weight=0.5, num_sequences=2, frames_per_sequence=6,
                                  label_dim=tree.num_pdfs)
        if e2e:
            sup.e2e_fsts = e2e_fsts(gk, tree, norm, 2, 3)
        else:
            sup.fst = ck.merge_supervision_fsts(chunks, 6)
        buf = io.BytesIO()
        ck.write_supervision(buf, sup)
        out[name] = buf.getvalue()
    assert out["t"] == out["j"]
    # newer Kaldi appends <AlignmentPdfs>; both readers parse and drop it
    data = out["t"].replace(b"</Supervision> ",
                            b"<AlignmentPdfs> \x04" + struct.pack("<4i", 3, 1, 2, 3)
                            + b"</Supervision> ")
    for blob in (out["t"], data):
        a = tc.read_supervision(io.BytesIO(blob))
        b = jc.read_supervision(io.BytesIO(blob))
        assert a.is_e2e == b.is_e2e == e2e
        for fa, fb in zip(a.e2e_fsts or [a.fst], b.e2e_fsts or [b.fst]):
            assert_same_fst(fa, fb)
    bad = io.BytesIO()
    with pytest.raises(ValueError, match="fst or e2e_fsts"):
        tc.write_supervision(bad, tc.KaldiSupervision(1.0, 1, 6, 4))


def _golden_example(ck, fk):
    """tests/test_cegs.py's golden example over package (ck, fk)."""
    fst1 = fk.Fst()
    fst1.add_states(3)
    fst1.add_arc(0, 1, -0.125, 1)
    fst1.add_arc(1, 2, -0.25, 2)
    fst1.set_final(2, -0.5)
    fst2 = fk.Fst()
    fst2.add_states(3)
    fst2.add_arc(0, 2, -0.0625, 1)
    fst2.add_arc(1, 1, -0.375, 2)
    fst2.set_final(2, 0.0)
    feats = np.arange(2 * 8 * 4, dtype=np.float32).reshape(2, 8, 4) / 16.0
    return ck.make_chain_example(feats, [fst1, fst2], label_dim=4, frame_subsampling_factor=3,
                                 left_context=1)


def test_golden_cegs_ark_parses_alike_and_the_writer_reproduces_it(tmp_path):
    got = tc.read_cegs_ark(str(FIXTURES / "golden_cegs.ark"))
    want = jc.read_cegs_ark(str(FIXTURES / "golden_cegs.ark"))
    assert list(got) == list(want) == ["eg-golden"]
    assert_same_example(got["eg-golden"], want["eg-golden"])
    p = tmp_path / "golden_cegs.ark"
    tc.write_cegs_ark(str(p), {"eg-golden": _golden_example(tc, tf)})
    assert p.read_bytes() == (FIXTURES / "golden_cegs.ark").read_bytes()


@pytest.mark.parametrize("compress", [False, True], ids=["FM", "CM"])
@pytest.mark.parametrize("e2e", [False, True], ids=["standard", "e2e"])
def test_examples_and_archives_give_the_same_bytes(tmp_path, compress, e2e):
    out = {}
    for side in SIDES:
        name, ck = side[:2]
        eg = make_example(side, ivector=True, e2e=e2e)
        out[name] = eg_bytes(ck, eg, compress)
        d = tmp_path / name
        d.mkdir()
        ck.write_cegs_ark(str(d / "cegs.1.ark"), [("eg-0", eg), ("eg-1", eg)],
                          compress=compress, scp_path=str(d / "cegs.1.scp"))
        out[name + "_ark"] = (d / "cegs.1.ark").read_bytes()
        out[name + "_scp"] = (d / "cegs.1.scp").read_text().replace(str(d), "DIR")
    for k in ("", "_ark", "_scp"):
        assert out["t" + k] == out["j" + k], k
    a = tc.read_chain_example(io.BytesIO(out["t"]))
    b = jc.read_chain_example(io.BytesIO(out["t"]))
    assert_same_example(a, b)
    assert [k for k, _ in tc.iter_cegs_ark(str(tmp_path / "t" / "cegs.1.ark"))] == ["eg-0", "eg-1"]
    with pytest.raises(ValueError, match="spaces"):
        tc.write_cegs_ark(str(tmp_path / "x.ark"), {"a b": a})


# ---------------------------------------------------------------------------
# merge and split
# ---------------------------------------------------------------------------


def _paths(fk, fst):
    """Label sequence -> log-sum of its paths' weights (merging folds
    parallel arcs, so paths, not label sequences, may differ in number)."""
    out = {}
    for labels, w in fk.enumerate_paths(fst):
        out[labels] = np.logaddexp(out.get(labels, -np.inf), w)
    return out


@pytest.mark.parametrize("seed,B", [(3, 4), (4, 3), (8, 2)])
def test_merge_and_split_are_inverses_and_match(seed, B):
    T = 6
    merged, pieces = {}, {}
    for name, ck, fk, gk in SIDES:
        chunks, *_ = setup_chunks(fk, gk, num_chunks=B, T=T, seed=seed)
        merged[name] = ck.merge_supervision_fsts(chunks, T)
        pieces[name] = ck.split_merged_supervision_fst(merged[name], B, T)
        if name == "t":
            for orig, piece in zip(chunks, pieces[name]):
                po, pp = _paths(fk, orig), _paths(fk, piece)
                assert sorted(po) == sorted(pp)
                np.testing.assert_allclose([pp[k] for k in po], list(po.values()), atol=1e-6)
    assert_same_fst(merged["t"], merged["j"])
    for a, b in zip(pieces["t"], pieces["j"]):
        assert_same_fst(a, b)
    chunks, *_ = setup_chunks(tf, tg, num_chunks=1)
    assert tc.split_merged_supervision_fst(chunks[0], 1, 6) == [chunks[0]]


def test_a_fst_not_made_by_merging_is_refused_alike():
    for _name, ck, fk, _gk in SIDES:
        bad = fk.Fst()
        bad.add_states(5)
        bad.add_arc(0, 1, 0.0, 1)
        bad.add_arc(0, 2, 0.0, 2)
        bad.add_arc(1, 1, 0.0, 3)
        bad.add_arc(2, 2, -0.5, 4)
        bad.add_arc(1, 2, 0.0, 4)
        bad.set_final(3)
        bad.set_final(4)
        with pytest.raises(ValueError, match="disagree"):
            ck.split_merged_supervision_fst(bad, 2, 1)
        skew = fk.Fst()
        skew.add_states(3)
        skew.add_arc(0, 1, 0.0, 1)
        skew.add_arc(0, 1, 0.0, 2)
        skew.add_arc(1, 1, 0.0, 2)
        skew.set_final(2)
        with pytest.raises(ValueError, match="frame-synchronous"):
            ck.split_merged_supervision_fst(skew, 2, 1)


# ---------------------------------------------------------------------------
# example_to_batch
# ---------------------------------------------------------------------------


def _legacy_dw(data: bytes, codes: np.ndarray) -> bytes:
    """Replace the <DW2> float vector of a written example by the legacy
    one-byte form (<DW>, WriteVectorAsChar)."""
    a = data.index(b"<DW2> ")
    b = data.index(b"</NnetChainSup>")
    return (data[:a] + b"<DW> \x04" + struct.pack("<i", codes.size)
            + codes.astype(np.uint8).tobytes() + data[b:])


def _online_ivectors(eg, ck, B, seed):
    rows = np.random.default_rng(seed).standard_normal((B, 2, 5)).astype(np.float32)
    eg.inputs = [i for i in eg.inputs if i.name != "ivector"] + [
        ck.NnetIo(name="ivector", indexes=[(n, t, 0) for n in range(B) for t in (0, 12)],
                  features=rows.reshape(B * 2, 5))]
    return eg


BATCH_CASES = {
    "plain": dict(),
    "ivector": dict(ivector=True),
    "no_ivector": dict(ivector=True, kw=dict(append_ivector=False)),
    "online_ivector": dict(ivector=True, online=True),
    "deriv_weights": dict(ramp=True),
    "legacy_deriv_weights": dict(legacy=True),
    "ignore_deriv_weights": dict(ramp=True, kw=dict(ignore_deriv_weights=True)),
    "sup_caps": dict(kw=dict(sup_caps=(48, 24, 16, 16))),
    "sup_caps_two": dict(kw=dict(sup_caps=(48, 24))),
    "e2e": dict(e2e=True),
    "e2e_caps_deriv_weights": dict(e2e=True, ramp=True, ivector=True, kw=dict(sup_caps=(24, 8))),
}


@pytest.mark.parametrize("case", sorted(BATCH_CASES))
def test_example_to_batch_gives_the_same_arrays(case):
    c = BATCH_CASES[case]
    B = 4
    batches = {}
    for side in SIDES:
        name, ck = side[:2]
        eg = make_example(side, B=B, seed=7, ivector=c.get("ivector", False),
                          e2e=c.get("e2e", False))
        if c.get("online"):
            eg = _online_ivectors(eg, ck, B, 11)
        if c.get("ramp"):
            eg.outputs[0].deriv_weights = np.linspace(0.5, 1.0, B * 6).astype(np.float32)
        data = eg_bytes(ck, eg)
        if c.get("legacy"):
            data = _legacy_dw(data, np.arange(B * 6) * 10 % 256)
        batches[name] = ck.example_to_batch(ck.read_chain_example(io.BytesIO(data)),
                                            **c.get("kw", {}))
    bt, bj = batches["t"], batches["j"]
    assert_same_arrays(bt.feats, bj.feats, "feats")
    assert_same_arrays(bt.sup, bj.sup, "sup")
    if c.get("ramp") and not c.get("kw", {}).get("ignore_deriv_weights"):
        np.testing.assert_array_equal(bt.sup.frame_weights.reshape(-1),
                                      np.linspace(0.5, 1.0, B * 6).astype(np.float32))
    elif not c.get("legacy"):
        assert bt.sup.frame_weights is None
    appended = c.get("ivector") and c.get("kw", {}).get("append_ivector", True)
    assert bt.feats.shape == (B, 6 * 3 + 6, 13 if appended else 8)


def test_example_to_batch_refuses_what_does_not_fit():
    eg = make_example(SIDES[0], B=3)
    with pytest.raises(ValueError):
        tc.example_to_batch(eg, sup_caps=(2, 2))
    eg.inputs[0].indexes = eg.inputs[0].indexes[:-1] + [eg.inputs[0].indexes[0]]
    with pytest.raises(ValueError, match="duplicate"):
        tc.example_to_batch(eg)


# ---------------------------------------------------------------------------
# CegsDataset and dataset_to_cegs
# ---------------------------------------------------------------------------


def _prep(tmp_path, e2e=False, n_archives=2, records_per=2, B=3):
    """A Kaldi prep's archives, written by the JAX package (the port's
    writer gives the same bytes: test_examples_and_archives_give_the_same_bytes)."""
    paths = []
    for a in range(n_archives):
        egs = {f"eg-{a}-{r}": make_example(SIDES[1], B=B, seed=13 * a + r, e2e=e2e)
               for r in range(records_per)}
        p = str(tmp_path / f"cegs.{a + 1}.ark")
        jc.write_cegs_ark(p, egs)
        paths.append(p)
    return paths


@pytest.mark.parametrize("e2e", [False, True], ids=["standard", "e2e"])
def test_cegs_dataset_gives_the_same_batches(tmp_path, e2e):
    paths = _prep(tmp_path, e2e=e2e)
    dt, dj = tc.CegsDataset(paths, seed=3), jc.CegsDataset(paths, seed=3)
    assert dt.peek() == dj.peek() and dt.peek()[2:] == (3, 6)
    assert dt.count_records() == dj.count_records() == 4
    caps = dt.estimate_sup_caps()
    assert caps == dj.estimate_sup_caps()
    runs = [dict(shuffle=False)] + [dict(epoch=e) for e in (0, 1, 2)] + [
        dict(shuffle=False, process_index=pi, process_count=3, sup_caps=caps) for pi in range(3)]
    for kw in runs:
        got, want = list(dt.batches(0, **kw)), list(dj.batches(0, **kw))
        assert len(got) == len(want) == (1 if "process_count" in kw else 4), kw
        for a, b in zip(got, want):
            assert_same_arrays(a.feats, b.feats, "feats")
            assert_same_arrays(a.sup, b.sup, "sup")
    # shuffle is a pure function of (seed, epoch): archives reorder, records keep
    order = [float(b.feats.sum()) for b in dt.batches(0, epoch=1)]
    assert order == [float(b.feats.sum()) for b in dt.batches(0, epoch=1)]
    assert sorted(order) == sorted(float(b.feats.sum()) for b in dt.batches(0, epoch=2))
    shapes = {b.sup.in_src.shape for b in dt.batches(0, sup_caps=caps)}
    assert len(shapes) == 1


def test_cegs_dataset_paths_and_errors(tmp_path):
    paths = _prep(tmp_path, n_archives=2, records_per=1)
    assert tc.CegsDataset(str(tmp_path / "cegs.*.ark")).paths == sorted(paths)
    assert tc.CegsDataset(",".join(paths)).paths == paths
    with pytest.raises(FileNotFoundError):
        tc.CegsDataset(str(tmp_path / "missing.ark"))
    with pytest.raises(ValueError, match="no cegs"):
        tc.CegsDataset([])
    (tmp_path / "empty.ark").write_bytes(b"")
    with pytest.raises(ValueError, match="empty cegs archive"):
        tc.CegsDataset(str(tmp_path / "empty.ark")).peek()
    keys = [k for k, _b in tc.batches_from_cegs(paths[0])]
    assert keys == ["eg-0-0"]


def _export_dataset(data_mod, graphs_mod, seed=0):
    c = data_mod.synthetic_dataset(num_utts=10, num_phones=8, feat_dim=12,
                                   utt_frames_out=(18, 24), seed=seed)
    return data_mod.ChainDataset(
        c.utts, c.tree, c.norm_fst, chunk_frames_out=15, left_context=6, right_context=6,
        sup_opts=graphs_mod.SupervisionOptions(left_tolerance=2, right_tolerance=2))


@pytest.mark.parametrize("compress,shuffle_seed", [(False, None), (True, None), (False, 4)],
                         ids=["FM", "CM", "shuffled"])
def test_dataset_to_cegs_writes_the_same_bytes(tmp_path, compress, shuffle_seed):
    import torchain_tpu.data as jdata
    import torchain_tpu_torch.data as tdata

    out = {}
    for name, ck, data_mod, gk in (("t", tc, tdata, tg), ("j", jc, jdata, jg)):
        d = tmp_path / name
        d.mkdir()
        n = ck.dataset_to_cegs(_export_dataset(data_mod, gk, seed=1), str(d / "egs.ark"),
                               batch_size=4, compress=compress, scp_path=str(d / "egs.scp"),
                               shuffle_seed=shuffle_seed)
        out[name] = (n, (d / "egs.ark").read_bytes(),
                     (d / "egs.scp").read_text().replace(str(d), "DIR"))
    assert out["t"] == out["j"]
    assert out["t"][0] >= 2
    # the exported features are the loader's own chunk slices
    ds = _export_dataset(tdata, tg, seed=1)
    slices = [ds._chunk_feats(ds.utts[ui], c0, t) for ui, c0, t, *_ in ds.chunks]
    for _key, batch in tc.batches_from_cegs(str(tmp_path / "t" / "egs.ark")):
        for f in batch.feats:
            assert any(s.shape == f.shape and (compress or np.array_equal(s, f))
                       for s in slices)


# ---------------------------------------------------------------------------
# cli/egs.py
# ---------------------------------------------------------------------------


def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


def test_egs_cli_matches(tmp_path):
    from torchain_tpu.cli.egs import main as jmain
    from torchain_tpu_torch.cli.egs import main as tmain

    steps = [
        ["get", "{d}/a.ark", "--synthetic", "--num-utts", "8", "--num-phones", "6",
         "--chunk-frames", "12", "--left-context", "4", "--right-context", "4",
         "--batch-size", "2", "--scp", "{d}/a.scp"],
        ["shuffle", "{d}/a.ark", "{d}/s.ark", "--seed", "1"],
        ["merge", "{d}/a.ark", "{d}/m.ark", "--batch-size", "4", "--scp", "{d}/m.scp"],
        ["copy", "{d}/a.ark", "{d}/c.ark", "--subset", "1", "--prefix", "x-"],
        ["copy", "{d}/s.ark", "{d}/e.ark", "--every-n", "2", "--compress"],
        ["info", "{d}/m.ark"],
        ["info", "{d}/e.ark"],
    ]
    for side, main in (("t", tmain), ("j", jmain)):
        (tmp_path / side).mkdir()
    for argv in steps:
        got = {}
        for side, main in (("t", tmain), ("j", jmain)):
            d = str(tmp_path / side)
            rc, text = _run(main, [a.format(d=d) for a in argv])
            assert rc == 0
            got[side] = text.replace(d, "DIR")
        assert got["t"] == got["j"], argv
    for f in ("a.ark", "a.scp", "s.ark", "m.ark", "m.scp", "c.ark", "e.ark"):
        t = (tmp_path / "t" / f).read_bytes()
        j = (tmp_path / "j" / f).read_bytes()
        if f.endswith(".scp"):
            t = t.replace(str(tmp_path / "t").encode(), b"DIR")
            j = j.replace(str(tmp_path / "j").encode(), b"DIR")
        assert t == j, f
    m = tc.read_cegs_ark(str(tmp_path / "t" / "m.ark"))
    assert all(eg.outputs[0].supervision.num_sequences == 4 for eg in m.values())
    rc = tmain(["get", str(tmp_path / "none.ark")])
    assert rc == 2


def test_egs_cli_merges_e2e_records_alike(tmp_path):
    from torchain_tpu.cli.egs import main as jmain
    from torchain_tpu_torch.cli.egs import main as tmain

    src = str(tmp_path / "e2e.ark")
    jc.write_cegs_ark(src, {f"eg-{r}": make_example(SIDES[1], B=2, seed=r, e2e=True,
                                                     ivector=True) for r in range(3)})
    outs = {}
    for side, main in (("t", tmain), ("j", jmain)):
        dst = str(tmp_path / f"m_{side}.ark")
        rc, text = _run(main, ["merge", src, dst, "--batch-size", "3"])
        assert rc == 0
        outs[side] = ((tmp_path / f"m_{side}.ark").read_bytes(), text.replace(dst, "OUT"))
    assert outs["t"] == outs["j"]
    eg = next(iter(tc.read_cegs_ark(str(tmp_path / "m_t.ark")).values()))
    assert eg.outputs[0].supervision.is_e2e and eg.has_io("ivector")
    mixed = str(tmp_path / "mixed.ark")
    jc.write_cegs_ark(mixed, [("a", make_example(SIDES[1], B=2, seed=0)),
                              ("b", make_example(SIDES[1], B=2, seed=1, e2e=True))])
    assert tmain(["merge", mixed, str(tmp_path / "x.ark"), "--batch-size", "2"]) == 2


# ---------------------------------------------------------------------------
# the chain loss of a cegs batch, and one train step from a Kaldi prep
# ---------------------------------------------------------------------------

OPTS = dict(l2_regularize=5e-4, leaky_hmm_coefficient=0.1, xent_regularize=0.1)


@pytest.mark.parametrize("frame_weights", [False, True], ids=["unit", "deriv_weights"])
@pytest.mark.parametrize("e2e", [False, True], ids=["standard", "e2e"])
def test_chain_loss_of_a_cegs_batch_matches_jax(e2e, frame_weights):
    import jax
    import jax.numpy as jnp
    import torch

    import torchain_tpu.ops as jops
    import torchain_tpu_torch.ops as tops
    from torchain_tpu.ops.den_resident import DeviceResidentDenGraph as JResident
    from torchain_tpu.ops.device_graphs import DeviceSupervision as JSup
    from torchain_tpu.ops.num_e2e import DeviceE2eSupervision as JE2e

    B = 3
    hosts = {}
    for side in SIDES:
        name, ck, fk, gk = side
        eg = make_example(side, B=B, seed=9, e2e=e2e)
        if frame_weights:
            eg.outputs[0].deriv_weights = np.linspace(0.25, 1.0, B * 6).astype(np.float32)
        _c, _t, graph, *_ = setup_chunks(fk, gk, num_chunks=B, seed=9, normalize=not e2e)
        hosts[name] = (ck.example_to_batch(eg).sup, graph)
    (tsup_h, tgraph), (jsup_h, jgraph) = hosts["t"], hosts["j"]
    assert (tsup_h.frame_weights is not None) == frame_weights
    P = jgraph.num_pdfs
    rng = np.random.default_rng(12)
    y = rng.normal(size=(B, 6, P)).astype(np.float32)
    x = rng.normal(size=(B, 6, P)).astype(np.float32)
    jden = JResident.from_host(jgraph, pad_to=8, dtype=jnp.float32)
    tden = tops.auto_den_graph(tgraph, pad_to=8, device="cpu")
    if e2e:
        jsup = JE2e.from_host(jsup_h)
        tsup = tops.DeviceE2eSupervision.from_host(tsup_h, device="cpu").with_kernel_tables()
    else:
        jsup = JSup.from_host(jsup_h).with_kernel_tables()
        tsup = tops.DeviceSupervision.from_host(tsup_h, device="cpu").with_kernel_tables()

    def jloss(y, x):
        return jops.chain_loss(y, x, jden, jsup, jops.ChainLossOptions(**OPTS))

    (l_j, aux_j), (dy_j, dx_j) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(y), jnp.asarray(x))
    yt = torch.tensor(y, requires_grad=True)
    xt = torch.tensor(x, requires_grad=True)
    l_t, aux_t = tops.chain_loss(yt, xt, tden, tsup, tops.ChainLossOptions(**OPTS))
    l_t.backward()
    np.testing.assert_allclose(float(l_t.detach()), float(l_j), rtol=1e-5)
    assert set(aux_t) == set(aux_j)
    for k in aux_j:
        np.testing.assert_allclose(float(aux_t[k].detach()), float(aux_j[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    assert float(aux_t["num_failed"]) == 0.0
    np.testing.assert_allclose(yt.grad.numpy(), np.asarray(dy_j), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx_j), rtol=1e-4, atol=1e-6)


def _write_den_fst(fk, gk, path, tree, seed=0):
    """tests/test_cegs_train.py's den.fst: a bigram phone LM expanded over
    `tree`, pdf+1 labels, standard arcs."""
    rng = np.random.default_rng(seed)
    sents = [[int(x) for x in rng.integers(1, 4, size=rng.integers(2, 6))] for _ in range(30)]
    den_fst = gk.make_den_fst(gk.estimate_phone_lm(sents, gk.PhoneLmOptions(ngram_order=2)), tree)
    fk.write_openfst(path, den_fst, [a.label for _s, a in den_fst.all_arcs()], arctype="standard")


@pytest.mark.parametrize("e2e", [False, True], ids=["standard", "e2e"])
def test_first_train_step_from_a_kaldi_prep_matches_jax(tmp_path, e2e):
    """The train-from-prep path: merged cegs archives + a binary den.fst,
    read back by each package (CegsDataset, _load_any_fst,
    compile_den_graph, the resident denominator), one step of each
    package's make_train_step from the same parameters."""
    import jax
    import jax.numpy as jnp
    import optax
    import torch

    from torchain_tpu.cli.graphs import _load_any_fst as j_load
    from torchain_tpu.models import TDNNF as JTDNNF
    from torchain_tpu.models import TdnnfConfig as JCfg
    from torchain_tpu.ops import ChainLossOptions as JOpts
    from torchain_tpu.ops.den_resident import DeviceResidentDenGraph as JResident
    from torchain_tpu.ops.device_graphs import DeviceSupervision as JSup
    from torchain_tpu.ops.num_e2e import DeviceE2eSupervision as JE2e
    from torchain_tpu.train import create_train_state as j_create
    from torchain_tpu.train import make_train_step as j_make_step
    from torchain_tpu_torch.cli.graphs import _load_any_fst as t_load
    from torchain_tpu_torch.convert import params_from_jax
    from torchain_tpu_torch.models import TDNNF, TdnnfConfig
    from torchain_tpu_torch.ops import (
        ChainLossOptions,
        DeviceE2eSupervision,
        DeviceSupervision,
        auto_den_graph,
    )
    from torchain_tpu_torch.train import create_train_state, make_train_step

    paths = _prep(tmp_path, e2e=e2e, n_archives=1, records_per=2)
    den_path = str(tmp_path / "den.fst")
    _write_den_fst(tf, tg, den_path, tg.ContextTree(3, context_width=1))

    dt = tc.CegsDataset(paths)
    feat_dim, num_pdfs, _bsz, _t_out = dt.peek()
    assert (feat_dim, num_pdfs) == jc.CegsDataset(paths).peek()[:2]
    tbatch = next(dt.batches(0, shuffle=False))
    jbatch = next(jc.CegsDataset(paths).batches(0, shuffle=False))
    t_fst, fmt, _ = t_load(den_path)
    assert fmt == "vector"
    tgraph = tg.compile_den_graph(t_fst, num_pdfs)
    jgraph = jg.compile_den_graph(j_load(den_path)[0], num_pdfs)

    small = dict(hidden_dim=64, bottleneck_dim=16, prefinal_dim=32, num_layers=2)
    jcfg = JCfg(num_pdfs=num_pdfs, dtype=jnp.float32, **small)
    tcfg = TdnnfConfig(num_pdfs=num_pdfs, dtype=torch.float32, **small)
    assert tcfg.context == (2, 4)
    feats = jnp.asarray(jbatch.feats)
    jstate = j_create(JTDNNF(jcfg), feats,
                      optax.chain(optax.clip_by_global_norm(5.0), optax.adam(1e-3)),
                      rng=jax.random.PRNGKey(1))
    jden = JResident.from_host(jgraph, pad_to=8, dtype=jnp.float32)
    jsup = JE2e.from_host(jbatch.sup) if e2e else JSup.from_host(jbatch.sup).with_kernel_tables()
    jstate2, jm = j_make_step(JOpts(**OPTS), donate=False)(jstate, feats, jden, jsup)

    model = TDNNF(tcfg, feat_dim, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jstate.params),
                                          jax.tree.map(np.asarray, jstate.batch_stats), tcfg))
    step = make_train_step(create_train_state(model, lr=1e-3), ChainLossOptions(**OPTS),
                           max_grad_norm=5.0)
    tden = auto_den_graph(tgraph, pad_to=8, device="cpu")
    cls = DeviceE2eSupervision if e2e else DeviceSupervision
    tsup = cls.from_host(tbatch.sup, device="cpu").with_kernel_tables()
    tm = step(torch.as_tensor(tbatch.feats), tden, tsup)
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4, atol=1e-7, err_msg=k)
    assert np.isfinite(float(tm["loss"]))
