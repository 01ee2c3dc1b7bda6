"""The port's binary OpenFst format (fstkit/openfst_io.py), its FST
algorithms (fstkit/algorithms.py) and its FST CLI (cli/graphs.py) against
the JAX package's.

Writers: the same bytes for the same seeded FSTs (vector and const bodies,
aligned and not; standard, lattice4 and compactlattice44 arcs).  Readers:
the same states, arcs and finals, from the golden fixtures too.
Algorithms, on seeded random acyclic acceptors with epsilon arcs and
unreachable states: the same FSTs (state numbering, arc order, labels,
destinations, finals), weights equal to 1e-12 absolute (both sides sum in
float64 in the same order, so they agree exactly in practice)."""

import contextlib
import io
import pathlib
import struct

import numpy as np
import pytest

import torchain_tpu.fstkit as jf
import torchain_tpu.fstkit.openfst_io as jo
import torchain_tpu_torch.fstkit as tf
import torchain_tpu_torch.fstkit.openfst_io as to

FIXTURES = pathlib.Path(__file__).parent / "fixtures"
ATOL = 1e-12


def raw_tuple(raw):
    """A RawFst of either package as plain tuples."""
    return (raw.fsttype, raw.arctype, raw.start, list(raw.finals),
            [[(a.ilabel, a.olabel, a.weight, a.nextstate) for a in arcs] for arcs in raw.arcs])


def fst_tuple(fst):
    """(num_states, arcs in order, finals) of an fstkit.Fst of either package."""
    arcs = [(s, a.label, a.dst, a.weight, a.weight2) for s, a in fst.all_arcs()]
    finals = [(fst.final(s), fst.final2(s)) if fst.is_final(s) else None
              for s in range(fst.num_states)]
    return fst.num_states, arcs, finals


def assert_same_fst(got, want):
    n1, a1, f1 = fst_tuple(got)
    n2, a2, f2 = fst_tuple(want)
    assert n1 == n2
    assert [x[:3] for x in a1] == [x[:3] for x in a2]
    np.testing.assert_allclose([x[3:] for x in a1], [x[3:] for x in a2], atol=ATOL)
    assert [f is None for f in f1] == [f is None for f in f2]
    np.testing.assert_allclose([f for f in f1 if f], [f for f in f2 if f], atol=ATOL)


def random_raw(rng, arctype, n=6):
    """A seeded transducer in the cost semiring: float32-exact weights,
    some states non-final (semiring Zero), strings on compact lattices."""
    nfl, has_str = jo.ARC_TYPES[arctype]

    def weight():
        w = tuple(float(np.float32(x)) for x in rng.normal(size=nfl))
        if has_str:
            w = w + (tuple(int(x) for x in rng.integers(1, 50, size=rng.integers(0, 4))),)
        return w

    zero = jo._zero_weight(arctype)
    finals = [weight() if rng.random() < 0.4 else zero for _ in range(n)]
    arcs = [[jo.RawArc(int(rng.integers(0, 5)), int(rng.integers(0, 9)), weight(),
                       int(rng.integers(0, n)))
             for _ in range(int(rng.integers(0, 4)))] for _ in range(n)]
    return jo.RawFst(fsttype="vector", arctype=arctype, start=int(rng.integers(0, n)),
                     finals=finals, arcs=arcs)


def as_port_raw(raw):
    return to.RawFst(fsttype=raw.fsttype, arctype=raw.arctype, start=raw.start,
                     finals=list(raw.finals),
                     arcs=[[to.RawArc(a.ilabel, a.olabel, a.weight, a.nextstate) for a in s]
                           for s in raw.arcs])


FORMS = [("standard", "vector", False), ("lattice4", "vector", False),
         ("compactlattice44", "vector", False), ("standard", "const", False),
         ("standard", "const", True), ("lattice4", "const", True)]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("arctype,fsttype,aligned", FORMS,
                         ids=[f"{a}-{f}{'-aligned' if al else ''}" for a, f, al in FORMS])
def test_openfst_writers_give_the_same_bytes_and_read_back(arctype, fsttype, aligned, seed):
    raw = random_raw(np.random.default_rng(seed), arctype)
    bt, bj = io.BytesIO(), io.BytesIO()
    to.write_fst_stream(bt, as_port_raw(raw), fsttype=fsttype, aligned=aligned)
    jo.write_fst_stream(bj, raw, fsttype=fsttype, aligned=aligned)
    assert bt.getvalue() == bj.getvalue()
    got = to.read_fst_stream(io.BytesIO(bt.getvalue()))
    want = jo.read_fst_stream(io.BytesIO(bt.getvalue()))
    assert raw_tuple(got) == raw_tuple(want)
    assert got.num_states == want.num_states and got.num_arcs == want.num_arcs
    # through fstkit: start swapped to 0, costs to log-probs, olabels aside
    (ft, ot), (fj, oj) = to.to_fstkit(got), jo.to_fstkit(want)
    assert ot == oj
    assert_same_fst(ft, fj)
    back_t = to.from_fstkit(ft, ot, arctype=arctype)
    back_j = jo.from_fstkit(fj, oj, arctype=arctype)
    assert raw_tuple(back_t) == raw_tuple(back_j)


@pytest.mark.parametrize("name,arctype,fsttype,aligned", [
    ("golden_vector_standard.fst", "standard", "vector", False),
    ("golden_const_aligned.fst", "standard", "const", True),
    ("golden_compactlattice44.fst", "compactlattice44", "vector", False),
])
def test_golden_fsts_parse_alike_and_the_writer_reproduces_them(tmp_path, name, arctype, fsttype,
                                                                  aligned):
    got = to.read_openfst_raw(str(FIXTURES / name))
    want = jo.read_openfst_raw(str(FIXTURES / name))
    assert raw_tuple(got) == raw_tuple(want)
    assert got.fsttype == fsttype and got.arctype == arctype
    p = tmp_path / name
    to.write_openfst_raw(str(p), got, fsttype=fsttype, aligned=aligned)
    assert p.read_bytes() == (FIXTURES / name).read_bytes()
    (ft, ot), (fj, oj) = to.read_openfst(str(FIXTURES / name)), jo.read_openfst(
        str(FIXTURES / name))
    assert ot == oj
    assert_same_fst(ft, fj)


def _symbol_table(name, entries):
    b = struct.pack("<i", jo.SYMBOL_TABLE_MAGIC)
    b += struct.pack("<i", len(name)) + name.encode()
    b += struct.pack("<qq", len(entries) + 1, len(entries))
    for sym, key in entries:
        b += struct.pack("<i", len(sym)) + sym.encode() + struct.pack("<q", key)
    return b


def test_headers_symbol_tables_and_stream_counts_read_alike():
    """Embedded symbol tables are skipped; a stream-written header (state
    count -1) runs to EOF in a file and is refused inside an archive; a
    bad magic, arc type or file type is refused with the same message."""
    raw = random_raw(np.random.default_rng(7), "standard")
    body = io.BytesIO()
    jo._write_vector_body(body, raw)

    def header(numstates, flags=0, fsttype="vector", arctype="standard", magic=jo.FST_MAGIC):
        h = io.BytesIO()
        jo._write_header(h, fsttype, arctype, 2, flags, 3, raw.start, numstates, raw.num_arcs)
        b = h.getvalue()
        return struct.pack("<i", magic) + b[4:]

    tables = _symbol_table("in", [("<eps>", 0), ("a", 1)]) + _symbol_table("out", [("x", 3)])
    with_tables = header(raw.num_states, flags=3) + tables + body.getvalue()
    streamed = header(-1) + body.getvalue()
    for data, kw in ((with_tables, {}), (streamed, {})):
        got = to.read_fst_stream(io.BytesIO(data), **kw)
        assert raw_tuple(got) == raw_tuple(jo.read_fst_stream(io.BytesIO(data), **kw))
        assert got.arcs == [[to.RawArc(a.ilabel, a.olabel, a.weight, a.nextstate) for a in s]
                            for s in raw.arcs]
    for data, kw in [(streamed, dict(allow_stream_counts=False)),
                     (header(raw.num_states, magic=5) + body.getvalue(), {}),
                     (header(raw.num_states, arctype="log") + body.getvalue(), {}),
                     (header(raw.num_states, fsttype="compact") + body.getvalue(), {}),
                     (header(raw.num_states) + body.getvalue()[:9], {})]:
        errs = []
        for mod in (to, jo):
            with pytest.raises(ValueError) as e:
                mod.read_fst_stream(io.BytesIO(data), **kw)
            errs.append(str(e.value))
        assert errs[0] == errs[1]
    with pytest.raises(ValueError, match="CompactLattice"):
        to.write_fst_stream(io.BytesIO(), as_port_raw(random_raw(
            np.random.default_rng(1), "compactlattice44")), fsttype="const")


def test_den_fst_round_trip_compiles_the_same_den_graph(tmp_path):
    """A den.fst written by each package (pdf+1 labels, standard arcs) from
    the same seeded corpus: the same bytes, and read back by the port it
    compiles to the JAX package's den graph, array for array."""
    import torchain_tpu.data as jdata
    import torchain_tpu.graphs as jgraphs
    import torchain_tpu_torch.data as tdata
    import torchain_tpu_torch.graphs as tgraphs

    kw = dict(num_utts=6, num_phones=5, feat_dim=4, utt_frames_out=(8, 12), seed=3,
              lm_order=3, lm_extra_states=20)
    files = {}
    for side, data, fk in (("t", tdata, tf), ("j", jdata, jf)):
        c = data.synthetic_dataset(**kw)
        files[side] = tmp_path / f"den_{side}.fst"
        fk.write_openfst(str(files[side]), c.den_fst,
                         [a.label for _s, a in c.den_fst.all_arcs()], arctype="standard")
        files[side + "_pdfs"] = c.tree.num_pdfs
    assert files["t"].read_bytes() == files["j"].read_bytes()
    gt = tgraphs.compile_den_graph(tf.read_openfst(str(files["t"]))[0], files["t_pdfs"])
    gj = jgraphs.compile_den_graph(jf.read_openfst(str(files["t"]))[0], files["j_pdfs"])
    for field in ("in_offsets", "in_src", "in_pdf", "in_logw", "out_offsets", "out_dst",
                  "out_pdf", "out_logw", "initial_probs"):
        a, b = getattr(gt, field), getattr(gj, field)
        assert a.dtype == b.dtype, field
        np.testing.assert_array_equal(a, b, err_msg=field)
    assert (gt.num_states, gt.num_pdfs) == (gj.num_states, gj.num_pdfs)


# ---------------------------------------------------------------------------
# algorithms
# ---------------------------------------------------------------------------


def random_acceptor(fk, seed, n=9, eps=0.25, clones=0):
    """A seeded acyclic acceptor of package `fk`: arcs only go forward in a
    hidden order (ids 1.. shuffled so topsort has work to do), a share
    `eps` of them epsilon, a few states unreachable or dead; `clones`
    states are duplicated with identical futures (bisimilar pairs)."""
    rng = np.random.default_rng(seed)
    ids = [0] + list(1 + rng.permutation(n - 1))
    fst = fk.Fst()
    fst.add_states(n + clones)
    for i in range(n):
        for _ in range(int(rng.integers(1, 4))):
            j = int(rng.integers(i + 1, n + 1))
            if j >= n:
                continue
            label = 0 if rng.random() < eps else int(rng.integers(1, 5))
            fst.add_arc(ids[i], label, float(-rng.random() * 2), ids[j])
        if rng.random() < 0.3 or i == n - 1:
            fst.set_final(ids[i], float(-rng.random()))
    for c in range(clones):
        src = ids[int(rng.integers(1, n - 1))]
        clone = n + c
        for a in fst.arcs(src):
            fst.add_arc(clone, a.label, a.weight, a.dst)
        if fst.is_final(src):
            fst.set_final(clone, fst.final(src))
        # a predecessor of src also reaches the clone
        preds = [s for s, a in fst.all_arcs() if a.dst == src and s < n]
        p = preds[0] if preds else 0
        fst.add_arc(p, 3, -0.5, clone)
    return fst


SEEDS = [0, 1, 2, 3, 4]


@pytest.mark.parametrize("seed", SEEDS)
def test_rm_epsilon_topsort_and_reverse_match(seed):
    ft, fj = random_acceptor(tf, seed), random_acceptor(jf, seed)
    assert_same_fst(ft, fj)
    rt, rj = tf.rm_epsilon(ft), jf.rm_epsilon(fj)
    assert_same_fst(rt, rj)
    assert not rt.has_epsilons()
    assert_same_fst(tf.topsort(ft), jf.topsort(fj))
    assert_same_fst(tf.reverse(ft), jf.reverse(fj))
    # a cycle is refused alike
    back = ft.arcs(0)[0].dst
    ft.add_arc(back, 0, 0.0, 0)
    fj.add_arc(back, 0, 0.0, 0)
    for fn in ("topsort", "shortest_distance"):
        for fk, f in ((tf, ft), (jf, fj)):
            with pytest.raises(ValueError):
                getattr(fk, fn)(f)
    cyc_t, cyc_j = tf.Fst(), jf.Fst()
    for f in (cyc_t, cyc_j):
        f.add_states(2)
        f.add_arc(0, 0, 0.0, 1)
        f.add_arc(1, 0, 0.0, 0)
        f.set_final(1)
    with pytest.raises(ValueError, match="epsilon-cycle"):
        tf.rm_epsilon(cyc_t)


@pytest.mark.parametrize("seed", SEEDS)
def test_merge_bisimilar_matches(seed):
    ft = tf.rm_epsilon(random_acceptor(tf, seed, clones=3))
    fj = jf.rm_epsilon(random_acceptor(jf, seed, clones=3))
    mt, mj = tf.merge_bisimilar(ft), jf.merge_bisimilar(fj)
    assert_same_fst(mt, mj)
    assert mt.num_states <= ft.num_states
    np.testing.assert_allclose(tf.total_weight(mt), tf.total_weight(ft), atol=1e-9)
    empty = tf.Fst()
    assert tf.merge_bisimilar(empty).num_states == 0


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("semiring", ["log", "tropical"])
def test_shortest_distance_total_weight_and_paths_match(seed, semiring):
    ft, fj = random_acceptor(tf, seed), random_acceptor(jf, seed)
    for rev in (False, True):
        dt = tf.shortest_distance(ft, reverse_dir=rev, semiring=semiring)
        dj = jf.shortest_distance(fj, reverse_dir=rev, semiring=semiring)
        np.testing.assert_allclose(dt, dj, atol=ATOL)
    np.testing.assert_allclose(tf.total_weight(ft, semiring), jf.total_weight(fj, semiring),
                               atol=ATOL)
    pt, pj = list(tf.enumerate_paths(ft)), list(jf.enumerate_paths(fj))
    assert [p for p, _ in pt] == [p for p, _ in pj]
    np.testing.assert_allclose([w for _, w in pt], [w for _, w in pj], atol=ATOL)
    if pt and semiring == "log":
        ws = np.array([w for _, w in pt])
        total = ws.max() + np.log(np.exp(ws - ws.max()).sum())
        np.testing.assert_allclose(tf.total_weight(ft), total, atol=1e-9)
    if len(pt) > 1:
        with pytest.raises(RuntimeError, match="too many"):
            list(tf.enumerate_paths(ft, max_paths=1))


# ---------------------------------------------------------------------------
# cli/graphs.py: info and convert
# ---------------------------------------------------------------------------


def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


CONVERTS = [[], ["--text"], ["--fsttype", "const"], ["--fsttype", "const", "--aligned"],
            ["--arctype", "lattice4"]]


@pytest.mark.parametrize("args", CONVERTS, ids=["vector", "text", "const", "const-aligned",
                                                "lattice4"])
def test_graphs_cli_info_and_convert_match(tmp_path, args):
    from torchain_tpu.cli.graphs import main as jmain
    from torchain_tpu_torch.cli.graphs import _load_any_fst
    from torchain_tpu_torch.cli.graphs import main as tmain

    src = tmp_path / "in.fst"
    tf.write_openfst(str(src), tf.rm_epsilon(random_acceptor(tf, 11)))
    outs = {}
    for side, main in (("t", tmain), ("j", jmain)):
        dst = tmp_path / f"out_{side}.fst"
        rc, text = _run(main, ["convert", str(src), str(dst)] + args)
        assert rc == 0 and text == f"wrote {dst}\n"
        outs[side] = dst.read_bytes()
        rc, info = _run(main, ["info", str(dst)])
        assert rc == 0
        outs[side + "_info"] = info.replace(str(dst), "OUT")
    assert outs["t"] == outs["j"]
    assert outs["t_info"] == outs["j_info"]
    fst, fsttype, arctype = _load_any_fst(str(tmp_path / "out_t.fst"))
    assert fsttype == ("text" if args == ["--text"] else "const" if "const" in args else "vector")
    assert arctype == ("lattice4" if "lattice4" in args else "standard")
    assert fst.num_states == tf.rm_epsilon(random_acceptor(tf, 11)).num_states
    # make-den-fst is ported too: on a dir without ali.txt it fails as the JAX tool does
    for main in (tmain, jmain):
        with pytest.raises(FileNotFoundError):
            main(["make-den-fst", str(tmp_path / "no_data"), str(tmp_path / "no_out")])
