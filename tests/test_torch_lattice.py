"""The port's lattice functions (eval/lattice.py) on the CPU against the JAX
package's, on the same decoded lattices: lattice_decode with the NumPy
reference and with the native core (phone, word and input-epsilon graphs,
the phone bonus, max_active), lattice_best_path, best_path_ctm and the CTM
files, determinize_lattice, lattice_nbest, rescore_lattice, score_sweep,
lattice_arc_posteriors, prune_lattice, lmrescore_lattice, mbr_decode,
lattice_oracle, and the text and binary lattice arks.

Both packages run the same code on the same inputs: lattices are held arc
for arc and bit for bit, the arks' bytes equal, MBR words exactly and
confidences to 1e-6.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

from tests.test_torch_decode import _graphs, jax_native_decoder, loglikes, word_graphs
from torchain_tpu.eval import lattice as jlat
from torchain_tpu_torch.eval import lattice as tlat


@pytest.fixture(scope="module", autouse=True)
def _jax_native():
    """The JAX package's native decoder, loaded before any test here runs its
    native backend (tests/test_torch_decode.py `jax_native_decoder`)."""
    return jax_native_decoder()



def signature(lat):
    """Everything a lattice holds: states, arcs in order with both weights,
    finals with both weights, and the state times of epsilon lattices."""
    arcs = [(s, a.label, a.weight, a.dst, a.weight2) for s, a in lat.all_arcs()]
    finals = [(s, lat.final(s), lat.final2(s)) for s in range(lat.num_states) if lat.is_final(s)]
    return lat.num_states, arcs, finals, getattr(lat, "state_times", None)


def decoded(kind, backend, seeds=(0, 1, 2), T=20, **kw):
    """(jax lattices, port lattices) of a few seeded utterances."""
    j, t = _graphs(kind)
    out = ([], [])
    for seed in seeds:
        y = loglikes(seed, T, t.num_pdfs, scale=kw.get("scale", 1.5))
        out[0].append(jlat.lattice_decode(j, y, beam=kw.get("beam", 8.0), backend=backend,
                                          phone_bonus=kw.get("bonus", 0.0),
                                          max_active=kw.get("max_active", 0)))
        out[1].append(tlat.lattice_decode(t, y, beam=kw.get("beam", 8.0), backend=backend,
                                          phone_bonus=kw.get("bonus", 0.0),
                                          max_active=kw.get("max_active", 0)))
    return out


@pytest.fixture(scope="module", params=["numpy", "native"])
def word_lattices(request):
    # peaked scores and a narrow beam keep the lattices small enough to
    # determinize
    return decoded("word", request.param, T=15, beam=5.0, scale=3.0)


@pytest.mark.parametrize("kind", ["phone", "word", "eps"])
@pytest.mark.parametrize("backend", ["numpy", "native"])
@pytest.mark.parametrize("bonus", [0.0, 0.5])
def test_lattice_decode_equals_jax(kind, backend, bonus):
    js, ts = decoded(kind, backend, bonus=bonus)
    for j, t in zip(js, ts):
        assert signature(t) == signature(j)
        assert tlat.lattice_best_path(t) == jlat.lattice_best_path(j)


def test_lattice_decode_max_active_equals_jax():
    js, ts = decoded("word", "native", beam=1e6, max_active=4)
    for j, t in zip(js, ts):
        assert signature(t) == signature(j)
    with pytest.raises(ValueError, match="max_active"):
        decoded("word", "numpy", seeds=(0,), max_active=4)


def test_best_path_equals_viterbi():
    """The JAX package's contract (tests/test_native_lattice.py): the
    lattice's best path is the Viterbi hypothesis, on both backends."""
    from torchain_tpu_torch.eval.decoder import viterbi_decode

    _, t = _graphs("word")
    for seed in range(3):
        y = loglikes(seed, 20, t.num_pdfs, scale=1.5)
        vh, vs = viterbi_decode(t, y, beam=8.0, backend="numpy")
        for backend in ("numpy", "native"):
            h, s = tlat.lattice_best_path(tlat.lattice_decode(t, y, beam=8.0, backend=backend))
            assert h == vh and s == pytest.approx(vs, abs=1e-4)


def test_determinize_nbest_rescore(word_lattices):
    for j, t in zip(*word_lattices):
        assert signature(tlat.determinize_lattice(t)) == signature(jlat.determinize_lattice(j))
        for det in (False, True):
            assert tlat.lattice_nbest(t, 5, determinize=det) == jlat.lattice_nbest(j, 5, determinize=det)
        for scale in (0.5, 7.0):
            assert signature(tlat.rescore_lattice(t, lm_scale=scale)) == signature(
                jlat.rescore_lattice(j, lm_scale=scale))


def test_score_sweep(word_lattices):
    js, ts = word_lattices
    refs = [[1, 2, 3], [4, 5], [2, 2, 6, 1]]
    for wip in (0.0, 0.5):
        assert tlat.score_sweep(ts, refs, lmwt_range=range(1, 6), word_insertion_penalty=wip) == \
            jlat.score_sweep(js, refs, lmwt_range=range(1, 6), word_insertion_penalty=wip)


def test_posteriors_prune_and_oracle(word_lattices):
    for j, t in zip(*word_lattices):
        tp, ttot = tlat.lattice_arc_posteriors(t)
        jp, jtot = jlat.lattice_arc_posteriors(j)
        assert ttot == jtot
        assert [(s, a.label, a.dst, p) for s, a, p in tp] == [(s, a.label, a.dst, p) for s, a, p in jp]
        for beam in (1.0, 4.0):
            assert signature(tlat.prune_lattice(t, beam)) == signature(jlat.prune_lattice(j, beam))
        for ref in ([1, 2, 3], [5]):
            assert tlat.lattice_oracle(t, ref) == jlat.lattice_oracle(j, ref)


def test_lmrescore(word_lattices):
    (jg, *_), (tg, *_) = word_graphs(seed=7, sil_phone=5)
    for j, t in zip(*word_lattices):
        for scale in (-1.0, 0.5):
            assert signature(tlat.lmrescore_lattice(t, tg, scale)) == signature(
                jlat.lmrescore_lattice(j, jg, scale))


def test_mbr(word_lattices):
    for j, t in zip(*word_lattices):
        for lat_t, lat_j in ((t, j), (tlat.rescore_lattice(t, lm_scale=3.0),
                                      jlat.rescore_lattice(j, lm_scale=3.0))):
            tr, jr = tlat.mbr_decode(lat_t), jlat.mbr_decode(lat_j)
            assert isinstance(tr, tlat.MbrResult)
            assert tr.words == jr.words and tr.slots == jr.slots
            np.testing.assert_allclose(tr.confidences, jr.confidences, rtol=1e-6, atol=0)
            assert tr.risk == pytest.approx(jr.risk, rel=1e-6)
            assert tr.map_risk == pytest.approx(jr.map_risk, rel=1e-6)
            assert len(tr.bins) == len(jr.bins)


@pytest.mark.parametrize("kind", ["word", "eps"])
def test_ctm_equals_jax(kind, tmp_path):
    js, ts = decoded(kind, "native")
    words = {w: f"w{w}" for w in range(1, 10)}
    for name, mod, lats in (("j", jlat, js), ("t", tlat, ts)):
        ctm = {f"u{i}": mod.best_path_ctm(lat, frame_shift_s=0.03) for i, lat in enumerate(lats)}
        mod.write_ctm(str(tmp_path / f"{name}.ctm"), ctm)
        mod.write_ctm(str(tmp_path / f"{name}_sym.ctm"), ctm, words_txt=words)
    for f in ("", "_sym"):
        assert (tmp_path / f"t{f}.ctm").read_bytes() == (tmp_path / f"j{f}.ctm").read_bytes()
    back_t = tlat.read_ctm(str(tmp_path / "t.ctm"))
    back_j = jlat.read_ctm(str(tmp_path / "t.ctm"))
    assert {u: [vars(e) for e in es] for u, es in back_t.items()} == {
        u: [vars(e) for e in es] for u, es in back_j.items()}


@pytest.mark.parametrize("backend", ["numpy", "native"])
def test_lattice_arks_equal_jax_bytes(backend, tmp_path):
    js, ts = decoded("word", backend)
    jd = {f"utt{i}": lat for i, lat in enumerate(js)}
    td = {f"utt{i}": lat for i, lat in enumerate(ts)}
    jlat.write_lattice_ark(str(tmp_path / "j.txt"), jd)
    tlat.write_lattice_ark(str(tmp_path / "t.txt"), td)
    assert (tmp_path / "t.txt").read_bytes() == (tmp_path / "j.txt").read_bytes()
    assert tlat.lattice_to_text(ts[0], "x") == jlat.lattice_to_text(js[0], "x")
    for compact in (True, False):
        jlat.write_lattice_ark_binary(str(tmp_path / "j.ark"), jd, compact=compact)
        tlat.write_lattice_ark_binary(str(tmp_path / "t.ark"), td, compact=compact)
        assert (tmp_path / "t.ark").read_bytes() == (tmp_path / "j.ark").read_bytes()
        back_t = tlat.read_lattice_ark_binary(str(tmp_path / "t.ark"))
        back_j = jlat.read_lattice_ark_binary(str(tmp_path / "t.ark"))
        assert {k: signature(v) for k, v in back_t.items()} == {
            k: signature(v) for k, v in back_j.items()}
    back_t = tlat.read_lattice_ark(str(tmp_path / "t.txt"))
    back_j = jlat.read_lattice_ark(str(tmp_path / "t.txt"))
    assert {k: signature(v) for k, v in back_t.items()} == {k: signature(v) for k, v in back_j.items()}
    # the text form reads back to the same best paths
    for k, lat in td.items():
        assert tlat.lattice_best_path(back_t[k])[0] == tlat.lattice_best_path(lat)[0]
