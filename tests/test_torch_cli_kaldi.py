"""The port's entry points for the Kaldi model files on the CPU, against the
JAX package's tools on the same files: `cli.graphs ali-to-phones` (binary,
text and gzip archives; both --reorder conventions) and `make-den-fst`
(their output files byte for byte), `cli.decode --hclg/--mdl` over a word
HCLG written with transition-id input labels (read back, it packs to the
graph built in process) and `cli.decode --tree` over a
triphone tied tree in Kaldi's text form (stdout, stderr and the JSON result
equal), and `cli.train --tied-tree-pdfs N --tied-tree-context
{left,triphone} --device cpu` at small widths: its loss falls, its
--metrics-out lines carry the JAX CLI's keys, and stage 0t's tree, den graph
and normalization FST equal what the JAX package builds on the same
synthetic corpus and seed."""

import dataclasses
import json

import numpy as np
import pytest

pytest.importorskip("jax")

from tests.test_torch_cli_train import JAX_METRIC_KEYS, SMALL, _falls, _metrics
from tests.test_torch_decode import jax_native_decoder
from tests.test_torch_tied_tree import stats_pair
from torchain_tpu.cli.decode import main as j_decode
from torchain_tpu.cli.graphs import main as j_graphs
from torchain_tpu_torch.cli import train as cli_train
from torchain_tpu_torch.cli.decode import main as t_decode
from torchain_tpu_torch.cli.graphs import main as t_graphs
from torchain_tpu_torch.data import train_word_lm
from torchain_tpu_torch.eval import hclg_decoding_graph, make_word_decoding_graph
from torchain_tpu_torch.fstkit import Fst
from torchain_tpu_torch.fstkit.openfst_io import read_openfst, write_openfst
from torchain_tpu_torch.graphs import (
    ContextTree,
    Lexicon,
    PhoneLmOptions,
    build_tied_tree,
    chain_transition_model,
    estimate_phone_lm,
    make_hclg,
    write_ali_ark,
    write_kaldi_tree,
    write_transition_model,
)
from torchain_tpu_torch.io import write_ark_binary


@pytest.fixture(scope="module", autouse=True)
def _jax_native():
    """The JAX package's native decoder, loaded before any test here runs its
    native backend (tests/test_torch_decode.py `jax_native_decoder`)."""
    return jax_native_decoder()



def _run(main, argv, capsys):
    res = main(argv)
    out, err = capsys.readouterr()
    return res, out, err


def _tids(tm, ali):
    """A (phone, frames) alignment as chain transition ids, in the --reorder
    order: each phone's forward id, then its self-loop ids."""
    fwd = {tm.transition_id_to_phone(t): t for t in range(1, tm.num_transition_ids + 1)
           if not tm.is_self_loop(t)}
    loop = {tm.transition_id_to_phone(t): t for t in range(1, tm.num_transition_ids + 1)
            if tm.is_self_loop(t)}
    return [x for p, d in ali for x in [fwd[p]] + [loop[p]] * (d - 1)]


def _alignments(seed, n=8, num_phones=5):
    rng = np.random.default_rng(seed)
    return {f"utt{u}": [(int(rng.integers(1, num_phones + 1)), int(rng.integers(1, 6)))
                        for _ in range(int(rng.integers(3, 7)))] for u in range(n)}


@pytest.mark.parametrize("flags", [[], ["--write-lengths"], ["--no-reorder"]])
def test_ali_to_phones_equals_the_jax_tool(tmp_path, capsys, flags):
    tm = chain_transition_model(5)
    mdl = str(tmp_path / "final.mdl")
    write_transition_model(mdl, tm)
    alis = _alignments(0)
    keys = sorted(alis)
    arks = []
    for i, (name, binary) in enumerate((("ali.1.gz", True), ("ali.2.ark", False))):
        part = {k: _tids(tm, alis[k]) for k in keys[i::2]}
        arks.append(str(tmp_path / name))
        write_ali_ark(arks[-1], part, binary=binary)
    outs = {}
    for tag, main in (("jax", j_graphs), ("port", t_graphs)):
        out = str(tmp_path / f"{tag}.txt")
        rc, stdout, stderr = _run(main, ["ali-to-phones", mdl, *arks, "--out", out, *flags], capsys)
        outs[tag] = (rc, stdout, stderr.replace(str(tmp_path / tag), "OUT"),
                     open(out, "rb").read())
    assert outs["port"] == outs["jax"]
    if not flags or flags == ["--write-lengths"]:
        from torchain_tpu_torch.data.kaldi_compat import read_alignments

        path = tmp_path / "port.txt"
        assert read_alignments(str(path)) == {k: alis[k] for k in keys[0::2] + keys[1::2]}
    # to stdout
    assert _run(t_graphs, ["ali-to-phones", mdl, arks[0]], capsys)[1] == _run(
        j_graphs, ["ali-to-phones", mdl, arks[0]], capsys)[1]


@pytest.mark.parametrize("context_width,order", [(1, 2), (2, 3)])
def test_make_den_fst_equals_the_jax_tool(tmp_path, capsys, context_width, order):
    alis = _alignments(1, n=12)
    (tmp_path / "ali.txt").write_text("".join(
        f"{u} " + " ; ".join(f"{p} ,{d}" for p, d in a) + "\n" for u, a in alis.items()))
    got = {}
    for tag, main in (("jax", j_graphs), ("port", t_graphs)):
        out = tmp_path / tag
        rc, stdout, _ = _run(main, ["make-den-fst", str(tmp_path), str(out), "--context-width",
                                    str(context_width), "--lm-order", str(order),
                                    "--lm-extra-states", "50"], capsys)
        got[tag] = (rc, stdout.replace(str(out), "OUT"),
                    *[(out / f).read_bytes() for f in ("den.fst", "normalization.fst",
                                                       "tree.json")])
    assert got["port"] == got["jax"]
    assert got["port"][0] == 0


def _posteriors(path, pdfs, n=4, T=(12, 20), seed=0):
    rng = np.random.default_rng(seed)
    posts = {f"utt{i}": (rng.normal(size=(int(rng.integers(*T)), pdfs)) * 2).astype(np.float32)
             for i in range(n)}
    write_ark_binary(str(path), posts)
    return posts


def _decode_both(argv, capsys):
    j = _run(j_decode, argv, capsys)
    t = _run(t_decode, argv, capsys)
    assert t[1] == j[1] and t[2] == j[2]
    assert json.dumps(t[0], sort_keys=True) == json.dumps(j[0], sort_keys=True)
    return t


def _word_files(tmp_path, num_phones=5, vocab=6, seed=2):
    rng = np.random.default_rng(seed)
    prons = {w: [tuple(int(q) for q in rng.integers(1, num_phones + 1,
                                                    size=int(rng.integers(1, 3))))]
             for w in range(1, vocab + 1)}
    refs = {f"utt{i}": [int(w) for w in rng.integers(1, vocab + 1, size=int(rng.integers(2, 4)))]
            for i in range(4)}
    g = train_word_lm(list(refs.values()) * 2, order=2, extra_states=20)
    (tmp_path / "g.txt").write_text(g.to_text())
    (tmp_path / "lexicon.txt").write_text(
        "".join(f"{w} {' '.join(map(str, p))}\n" for w, ps in prons.items() for p in ps))
    (tmp_path / "ref.txt").write_text(
        "".join(f"{u} {' '.join(map(str, ws))}\n" for u, ws in refs.items()))
    return g, Lexicon(prons=prons, sil_phone=0, sil_prob=0.5)


def test_decode_over_a_kaldi_hclg_equals_the_jax_tool(tmp_path, capsys):
    """A word HCLG over the monophone tree, its ilabels pdf+1 relabelled to
    the transition ids of the chain transition model (one per pdf), written
    as a binary OpenFst with final.mdl beside it."""
    tree = ContextTree(5)
    g, lex = _word_files(tmp_path)
    fst, olabels = make_hclg(g, lex, tree)
    tm = chain_transition_model(5)
    tid_of = {int(tm.id2pdf[t]): t for t in range(1, tm.num_transition_ids + 1)}
    assert len(tid_of) == tree.num_pdfs
    hclg = Fst()
    hclg.add_states(fst.num_states)
    for s, a in fst.all_arcs():
        hclg.add_arc(s, tid_of[a.label - 1] if a.label else 0, a.weight, a.dst)
    for s in range(fst.num_states):
        if fst.is_final(s):
            hclg.set_final(s, fst.final(s))
    write_openfst(str(tmp_path / "HCLG.fst"), hclg, olabels)
    write_transition_model(str(tmp_path / "final.mdl"), tm)
    # read back, it packs to the graph built in process (weights float32 both ways)
    from_file = hclg_decoding_graph(*read_openfst(str(tmp_path / "HCLG.fst")), tm)
    built = make_word_decoding_graph(g, lex, tree)
    for f in dataclasses.fields(built):
        a, b = getattr(from_file, f.name), getattr(built, f.name)
        assert np.array_equal(a, b) if isinstance(b, np.ndarray) else a == b, f.name
    _posteriors(tmp_path / "post.ark", tree.num_pdfs)
    res, out, _ = _decode_both(
        ["--posteriors", str(tmp_path / "post.ark"), "--hclg", str(tmp_path / "HCLG.fst"),
         "--mdl", str(tmp_path / "final.mdl"), "--ref", str(tmp_path / "ref.txt"),
         "--nbest", "2", "--backend", "numpy"], capsys)
    assert res["num_utts"] == 4 and np.isfinite(res["wer"])
    with pytest.raises(SystemExit, match="--mdl"):
        t_decode(["--posteriors", str(tmp_path / "post.ark"), "--hclg",
                  str(tmp_path / "HCLG.fst")])


@pytest.mark.parametrize("mode", ["phone", "word"])
def test_decode_with_a_kaldi_tree_equals_the_jax_tool(tmp_path, capsys, mode):
    _decode_with_a_kaldi_tree(tmp_path, capsys, mode)


def test_a_failed_first_load_of_the_jax_decoder_is_recovered(tmp_path, capsys, monkeypatch):
    """The race `jax_native_decoder` repairs, made in this process: the JAX
    loader's library path points at a file cut short (32 bytes, less than
    an ELF header, as another process's link has just begun it), and a
    first load fails and marks the library as failed for the process.  The
    helper re-arms the loader and points it at its own whole build, and
    leaves the short file as it was; both Kaldi-tree decodes then run
    against the library it returns."""
    from torchain_tpu.eval import native as jnative

    real = jnative._SO
    jax_native_decoder()
    part = tmp_path / "libtorchain_tpu_native.so"
    part.write_bytes(real.read_bytes()[:32])
    monkeypatch.setattr(jnative, "_SO", part)
    monkeypatch.setattr(jnative, "_lib", None)
    monkeypatch.setattr(jnative, "_load_failed", False)
    assert jnative.get_lib() is None and jnative._load_failed  # the first load fails
    lib = jax_native_decoder()
    assert lib is not None and jnative.get_lib() is lib and not jnative._load_failed
    assert jnative._SO != part and part.stat().st_size == 32
    for mode in ("phone", "word"):
        _decode_with_a_kaldi_tree(tmp_path / mode, capsys, mode)


def _decode_with_a_kaldi_tree(tmp_path, capsys, mode):
    tmp_path.mkdir(exist_ok=True)
    _j, t, sents = stats_pair("triphone", 0)
    tree = build_tied_tree(t, 40)
    assert tree.right_dependent(0) or tree.right_dependent(1)
    (tmp_path / "tree.txt").write_text(write_kaldi_tree(tree))
    _posteriors(tmp_path / "post.ark", tree.num_pdfs, n=3)
    argv = ["--posteriors", str(tmp_path / "post.ark"), "--tree", str(tmp_path / "tree.txt"),
            "--mode", mode, "--backend", "native"]
    if mode == "phone":
        lm = estimate_phone_lm(sents, PhoneLmOptions(ngram_order=2, num_extra_lm_states=40))
        (tmp_path / "lm.txt").write_text(lm.to_text())
        argv += ["--phone-lm", str(tmp_path / "lm.txt")]
    else:
        _word_files(tmp_path, num_phones=4)
        argv += ["--lexicon", str(tmp_path / "lexicon.txt"), "--word-lm",
                 str(tmp_path / "g.txt"), "--ref", str(tmp_path / "ref.txt")]
    res, out, _ = _decode_both(argv, capsys)
    assert res["num_utts"] == 3 and out


def _jax_stage_0t(context, num_utts, seed, pdfs):
    """What the JAX CLI's stage 0t builds on its synthetic corpus."""
    from torchain_tpu.data import synthetic_dataset
    from torchain_tpu.graphs import (
        accumulate_tree_stats,
        build_tied_tree as j_build,
        compile_den_graph,
        make_den_fst,
        make_normalization_fst,
    )

    c = synthetic_dataset(num_utts=num_utts, num_phones=4, feat_dim=24, seed=seed)
    stats = accumulate_tree_stats(c.utts, 4, frame_subsampling_factor=3, context=context)
    tree = j_build(stats, num_pdfs=pdfs)
    den_fst = make_den_fst(c.phone_lm, tree)
    graph = compile_den_graph(den_fst, tree.num_pdfs)
    return tree, den_fst, graph, make_normalization_fst(den_fst, graph.initial_probs)


def _arcs(fst):
    return [(s, a.label, a.weight, a.dst) for s, a in fst.all_arcs()]


@pytest.mark.parametrize("context", ["left", "triphone"])
def test_train_cli_on_a_tied_tree(tmp_path, monkeypatch, context):
    seen = []
    stage = cli_train.tied_tree_stage

    def keep(args, corpus):
        stage(args, corpus)
        seen.append(corpus)

    monkeypatch.setattr(cli_train, "tied_tree_stage", keep)
    out = str(tmp_path / "m.jsonl")
    res = cli_train.main(["--synthetic", "--device", "cpu", "--num-utts", "16", "--num-phones",
                          "4", "--tied-tree-pdfs", "40", "--tied-tree-context", context,
                          "--batch-size", "4", "--epochs", "3", "--lr", "3e-3", "--log-every",
                          "1", "--metrics-out", out, "--seed", "2", "--chunk-frames", "20",
                          *SMALL])
    lines = _metrics(out)
    assert res["steps"] == len(lines) >= 4
    assert all(set(m) == JAX_METRIC_KEYS for m in lines)
    _falls(lines)
    (corpus,) = seen
    tree, den_fst, graph, norm = _jax_stage_0t(context, 16, 2, 40)
    assert np.array_equal(corpus.tree.pdf_map, tree.pdf_map)
    assert corpus.tree.right_size == (5 if context == "triphone" else 1)
    assert _arcs(corpus.den_fst) == _arcs(den_fst)
    for f in dataclasses.fields(graph):
        a, b = getattr(corpus.den_graph, f.name), getattr(graph, f.name)
        assert np.array_equal(a, b) if isinstance(b, np.ndarray) else a == b, f.name
    assert _arcs(corpus.norm_fst) == _arcs(norm)
    assert [corpus.norm_fst.final(s) for s in range(norm.num_states)] == [
        norm.final(s) for s in range(norm.num_states)]
    assert corpus.dense_den is None
    assert res["den"] == dict(form="DeviceResidentDenGraph", states=graph.num_states,
                              arcs=graph.num_arcs, pdfs=tree.num_pdfs)
    assert res["timings"]["stages_s"]["tree_s"] > 0


def test_a_tied_tree_checkpoint_resumes_and_another_tree_is_refused(tmp_path, monkeypatch):
    """The Trainer fingerprints the tied tree's pdf map into its checkpoints
    (`tree_fingerprint`): the same run resumes from them; a run on another
    tied tree is refused, and so is the same den graph under a changed map."""
    from torchain_tpu_torch.ops import auto_den_graph
    from torchain_tpu_torch.train import Trainer, TrainerConfig

    ck = str(tmp_path / "ck")
    seen = []
    stage = cli_train.tied_tree_stage

    def keep(args, corpus):
        stage(args, corpus)
        seen.append(corpus)

    monkeypatch.setattr(cli_train, "tied_tree_stage", keep)
    common = ["--synthetic", "--device", "cpu", "--num-utts", "16", "--num-phones", "4",
              "--tied-tree-context", "left", "--batch-size", "4", "--epochs", "4",
              "--seed", "2", "--chunk-frames", "20", "--checkpoint-dir", ck, *SMALL]
    first = cli_train.main([*common, "--tied-tree-pdfs", "40", "--steps", "2"])
    assert first["steps"] == 2
    second = cli_train.main([*common, "--tied-tree-pdfs", "40", "--steps", "4"])
    assert second["steps"] == 4 and second["timings"]["ckpt_read"][0][0] == 2
    with pytest.raises(ValueError, match="refusing to resume"):
        cli_train.main([*common, "--tied-tree-pdfs", "30", "--steps", "6"])
    corpus = seen[0]
    other = type(corpus.tree)(corpus.tree.pdf_map[..., ::-1, :].copy(), corpus.tree.num_phones)
    model, _ = cli_train._build_model(cli_train.build_argparser().parse_args(common),
                                      corpus.tree.num_pdfs, 24, "cpu")
    den = auto_den_graph(corpus.den_graph, device="cpu")
    same = Trainer(model, den, TrainerConfig(checkpoint_dir=ck, device="cpu"), tree=corpus.tree)
    assert same.restore_checkpoint() and int(same.state.step) == 4
    changed = Trainer(model, den, TrainerConfig(checkpoint_dir=ck, device="cpu"), tree=other)
    with pytest.raises(ValueError, match="tree fingerprint changed"):
        changed.restore_checkpoint()
