"""The port's decode entry points on the CPU: cli/decode.py against the JAX
package's cli/decode.py on the same files (phone mode with n-best; word
mode with the LMWT sweep, MBR with --confidence-out, --lattice-out,
--ctm-out, --lm-rescore, --oracle and --word-symbols), its two backends
against each other, and cli/train.py's decode stages and flat-start
ladder (`--synthetic-words --decode --flat-start-ladder --device cpu`).

Both CLIs run the same host code on the same posteriors: stdout, stderr
(the JSON line included) and every output file must be equal.  The
native core and the NumPy reference hold their lattices in another arc
order and sum scores in float32 and float64 respectively, so between the
backends the hypotheses and n-best lists are held equal and the lattices
by content (the JAX package's own contract, tests/test_native_lattice.py).
"""

import json

import numpy as np
import pytest

pytest.importorskip("jax")

from torchain_tpu.cli.decode import main as j_decode
from tests.test_torch_decode import jax_native_decoder
from torchain_tpu_torch.cli.decode import main as t_decode
from torchain_tpu_torch.data import train_word_lm
from torchain_tpu_torch.eval.lattice import lattice_best_path, read_lattice_ark
from torchain_tpu_torch.fstkit import shortest_distance
from torchain_tpu_torch.graphs import PhoneLmOptions, estimate_phone_lm
from torchain_tpu_torch.graphs.topology import ContextTree
from torchain_tpu_torch.io import write_ark_binary

NUM_PHONES, VOCAB = 5, 6


@pytest.fixture(scope="module", autouse=True)
def _jax_native():
    """The JAX package's native decoder, loaded before any test here runs its
    native backend (tests/test_torch_decode.py `jax_native_decoder`)."""
    return jax_native_decoder()



def _fixture(tmp_path):
    """Posteriors of 3 utterances (peaked at a seeded path), a phone LM, a
    lexicon, word grammars, references and a symbol table, as files."""
    tmp_path.mkdir()
    rng = np.random.default_rng(0)
    tree = ContextTree(NUM_PHONES)
    prons = {w: [int(q) for q in rng.integers(1, NUM_PHONES + 1, size=int(rng.integers(1, 3)))]
             for w in range(1, VOCAB + 1)}
    refs = {f"utt{i}": [int(w) for w in rng.integers(1, VOCAB + 1, size=int(rng.integers(2, 4)))]
            for i in range(3)}
    posts = {}
    for utt, words in refs.items():
        phones = [q for w in words for q in prons[w]]
        frames, left = [], 0
        for q in phones:
            d = int(rng.integers(2, 4))
            frames += [tree.pdf(q, 0, left)] + [tree.pdf(q, 1, left)] * (d - 1)
            left = q
        y = rng.normal(size=(len(frames), tree.num_pdfs)).astype(np.float32)
        y[np.arange(len(frames)), frames] += 2.5
        posts[utt] = y
    write_ark_binary(str(tmp_path / "post.ark"), posts)
    sents = [[q for w in ws for q in prons[w]] for ws in refs.values()] * 3
    plm = estimate_phone_lm(sents, PhoneLmOptions(ngram_order=2, num_extra_lm_states=20))
    (tmp_path / "phone_lm.txt").write_text(plm.to_text())
    (tmp_path / "lexicon.txt").write_text(
        "".join(f"{w} {' '.join(map(str, p))}\n" for w, p in prons.items()))
    (tmp_path / "ref.txt").write_text("".join(f"{u} {' '.join(map(str, ws))}\n" for u, ws in refs.items()))
    (tmp_path / "ref_sym.txt").write_text(
        "".join(f"{u} {' '.join(f'w{w}' for w in ws)}\n" for u, ws in refs.items()))
    (tmp_path / "phone_ref.txt").write_text(
        "".join(f"{u} {' '.join(str(q) for w in ws for q in prons[w])}\n" for u, ws in refs.items()))
    (tmp_path / "words.txt").write_text("<eps> 0\n" + "".join(f"w{w} {w}\n" for w in range(1, VOCAB + 1)))
    g = train_word_lm(list(refs.values()) * 2, order=2, extra_states=20)
    (tmp_path / "g.txt").write_text(g.to_text())
    g2 = train_word_lm([ws[::-1] for ws in refs.values()] + list(refs.values()), order=2,
                       extra_states=20)
    (tmp_path / "g_new.txt").write_text(g2.to_text())
    return tmp_path


def _run(main, argv, capsys):
    res = main(argv)
    out, err = capsys.readouterr()
    return res, out, err


def _both(tmp_path, capsys, args, outputs):
    """Run both CLIs with `args`, each writing `outputs` (flag -> file
    name) into its own directory; assert equal stdout, stderr, JSON and
    files."""
    runs = []
    for tag, main in (("j", j_decode), ("t", t_decode)):
        d = tmp_path / tag
        d.mkdir()
        extra = [x for flag, name in outputs.items() for x in (flag, str(d / name))]
        runs.append((d, *_run(main, args + extra, capsys)))
    (jd, jres, jout, jerr), (td, tres, tout, terr) = runs
    assert tout == jout
    assert terr == jerr
    assert json.loads(terr.strip().splitlines()[-1]) == json.loads(jerr.strip().splitlines()[-1])
    assert tres == jres
    for name in outputs.values():
        assert (td / name).read_bytes() == (jd / name).read_bytes(), name
    return tres, tout


@pytest.fixture
def files(tmp_path):
    return _fixture(tmp_path / "in")


def test_phone_mode_with_nbest_equals_jax(files, tmp_path, capsys):
    args = ["--posteriors", str(files / "post.ark"), "--num-phones", str(NUM_PHONES),
            "--phone-lm", str(files / "phone_lm.txt"), "--ref", str(files / "phone_ref.txt"),
            "--nbest", "3", "--beam", "10"]
    res, out = _both(tmp_path, capsys, args, {"--lattice-out": "lat.txt", "--ctm-out": "a.ctm",
                                              "--hyp-out": "hyp.txt"})
    assert res["num_utts"] == 3 and np.isfinite(res["wer"])
    assert out.count("# nbest") >= 3


def test_phone_mode_viterbi_equals_jax(files, tmp_path, capsys):
    args = ["--posteriors", str(files / "post.ark"), "--num-phones", str(NUM_PHONES),
            "--phone-lm", str(files / "phone_lm.txt"), "--ref", str(files / "phone_ref.txt"),
            "--phone-insertion-bonus", "0.3", "--max-active", "50"]
    res, _ = _both(tmp_path, capsys, args, {"--hyp-out": "hyp.txt"})
    assert set(res["hyps"]) == {"utt0", "utt1", "utt2"}


@pytest.mark.parametrize("extra", [
    ["--lmwt-min", "1", "--lmwt-max", "4", "--mbr"],
    ["--mbr", "--lm-rescore", "g_new.txt", "--lm-rescore-old", "g.txt", "--oracle"],
    ["--lmwt-min", "2", "--lmwt-max", "3", "--word-ins-penalty", "0.5", "--prune-beam", "6",
     "--backend", "numpy", "--oracle"],
])
def test_word_mode_equals_jax(files, tmp_path, capsys, extra):
    extra = [str(files / x) if x.endswith(".txt") else x for x in extra]
    args = ["--posteriors", str(files / "post.ark"), "--mode", "word", "--num-phones",
            str(NUM_PHONES), "--lexicon", str(files / "lexicon.txt"), "--word-lm",
            str(files / "g.txt"), "--ref", str(files / "ref_sym.txt"), "--word-symbols",
            str(files / "words.txt"), "--beam", "10", *extra]
    outputs = {"--lattice-out": "lat.txt", "--ctm-out": "a.ctm", "--hyp-out": "hyp.txt"}
    if "--mbr" in extra:
        outputs["--confidence-out"] = "conf.txt"
    res, out = _both(tmp_path, capsys, args, outputs)
    assert out.split()[1].startswith("w")  # symbols, not ids
    assert np.isfinite(res["wer"])
    if "--lmwt-min" in extra:
        assert "best_lmwt" in res
    if "--oracle" in extra:
        assert res["oracle_wer"] <= res["wer"]


def test_word_mode_trains_its_grammar_from_ref(files, tmp_path, capsys):
    args = ["--posteriors", str(files / "post.ark"), "--mode", "word", "--num-phones",
            str(NUM_PHONES), "--sil-phone", "5", "--lexicon", str(files / "lexicon.txt"),
            "--ref", str(files / "ref.txt"), "--nbest", "2"]
    _both(tmp_path, capsys, args, {"--hyp-out": "hyp.txt"})


def test_flags_left_out_and_refusals(files, capsys):
    base = ["--posteriors", str(files / "post.ark")]
    # --hclg needs --mdl; a --tree file still needs a phone LM; --device is not a flag
    tree = files / "tree.txt"
    tree.write_text("ContextDependency 2 1 ToPdf TE -1 2 ( TE 1 3 ( NULL CE 0 CE 1 ) "
                    "TE 1 3 ( NULL CE 2 CE 3 ) ) EndContextDependency")
    for argv in (base + ["--hclg", "x"], base + ["--tree", str(tree)], base + ["--device", "cpu"]):
        with pytest.raises(SystemExit):
            t_decode(argv)
    for argv in (base + ["--phone-lm", str(files / "phone_lm.txt")],
                 base + ["--num-phones", "5"],
                 base + ["--num-phones", "5", "--phone-lm", str(files / "phone_lm.txt"),
                         "--lmwt-min", "1", "--lmwt-max", "2"]):
        with pytest.raises(SystemExit):
            t_decode(argv)
    capsys.readouterr()


def _lattice_content(lat):
    words, score = lattice_best_path(lat)
    total = shortest_distance(lat, reverse_dir=True, semiring="log")[0]
    return lat.num_states, lat.num_arcs, words, score, total


def test_native_and_numpy_backends_agree(files, tmp_path, capsys):
    """What chip_smoke.py's decode phase holds of the two backends: the
    same stdout (hypotheses and n-best lists), and lattices of the same
    content."""
    args = ["--posteriors", str(files / "post.ark"), "--num-phones", str(NUM_PHONES),
            "--phone-lm", str(files / "phone_lm.txt"), "--nbest", "3"]
    outs, lats = [], []
    for backend in ("native", "numpy"):
        path = tmp_path / f"{backend}.txt"
        _, out, _ = _run(t_decode, args + ["--backend", backend, "--lattice-out", str(path)], capsys)
        outs.append(out)
        lats.append(read_lattice_ark(str(path)))
    assert outs[0] == outs[1]
    assert lats[0].keys() == lats[1].keys()
    for utt in lats[0]:
        a, b = _lattice_content(lats[0][utt]), _lattice_content(lats[1][utt])
        assert a[:3] == b[:3]
        assert a[3] == pytest.approx(b[3], abs=1e-4) and a[4] == pytest.approx(b[4], abs=1e-4)


def test_train_decode_stages_and_ladder(tmp_path, capsys):
    from torchain_tpu_torch.cli.train import main as train_main

    res = train_main([
        "--synthetic-words", "--decode", "--lmwt-min", "1", "--lmwt-max", "3", "--mbr",
        "--flat-start-ladder", "--device", "cpu", "--num-layers", "2", "--hidden-dim", "32",
        "--bottleneck-dim", "8", "--num-utts", "12", "--num-phones", "6", "--feat-dim", "8",
        "--vocab-size", "8", "--batch-size", "4", "--epochs", "1", "--decode-beam", "10",
        "--checkpoint-dir", str(tmp_path / "ck"),
    ])
    out = capsys.readouterr().out
    for stage in ("[ladder 1]", "[ladder 2]", "[ladder 3]", "[stage 4] PER", "[stage 5] HCLG",
                  "[stage 5m] MBR WER"):
        assert stage in out
    for key in ("per", "wer", "best_lmwt", "mbr_wer", "objf"):
        assert np.isfinite(res[key]), key
    assert 1 <= res["best_lmwt"] <= 3
    dec = res["decode"]
    assert dec["utts"] == 12 and dec["hclg_states"] > 0 and dec["hclg_arcs"] > 0
    assert set(res["timings"]["stages_s"]) >= {"ladder_e2e_s", "ladder_align_s", "train_s",
                                               "decode_s"}
    assert json.loads(out.strip().splitlines()[-1])["wer"] == res["wer"]
