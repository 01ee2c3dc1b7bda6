"""The port's Kaldi transition model (torchain_tpu_torch/graphs/
transition_model.py) against the JAX package's: the binary and text bytes
of HmmTopology and TransitionModel in both layouts (the chain topology,
which is not an HMM, and a 3-state Bakis HMM), every derived map,
`ali_to_phones` under both --reorder conventions, `ali_to_pdfs`, and the
alignment archives (binary, text and gzip), on alignments drawn from a
seed."""

import io

import numpy as np
import pytest

pytest.importorskip("jax")

from torchain_tpu.graphs import transition_model as jtm
from torchain_tpu_torch.graphs import transition_model as ttm


def _bakis(mod, num_phones=3):
    """The classic 3-emitting-state Bakis topology, one pdf per state (an
    HMM: <Triples>, no sentinel), built by module `mod`."""
    entry = [
        mod.HmmState(0, 0, [(0, 0.5), (1, 0.5)]),
        mod.HmmState(1, 1, [(1, 0.5), (2, 0.5)]),
        mod.HmmState(2, 2, [(2, 0.5), (3, 0.5)]),
        mod.HmmState(mod.NO_PDF, mod.NO_PDF, []),
    ]
    phones = list(range(1, num_phones + 1))
    topo = mod.HmmTopology(phones=phones, phone2idx=[-1] + [0] * num_phones, entries=[entry])
    tuples = [(p, s, (p - 1) * 3 + s, (p - 1) * 3 + s) for p in phones for s in range(3)]
    lp = np.log(np.random.default_rng(num_phones).uniform(0.1, 0.9, 2 * len(tuples) + 1))
    return mod.TransitionModel(topo=topo, tuples=tuples, log_probs=lp.astype(np.float32))


def _chain(mod, num_phones=5):
    return mod.chain_transition_model(num_phones)


def _remapped(mod, num_phones=4):
    """The chain layout with a tied, shuffled pdf map."""
    rng = np.random.default_rng(7)
    pdfs = rng.permutation(2 * num_phones) // 2  # pairs share pdfs
    return mod.chain_transition_model(
        num_phones,
        {p: (int(pdfs[2 * p - 2]), int(pdfs[2 * p - 1])) for p in range(1, num_phones + 1)})


MODELS = {"chain": _chain, "bakis": _bakis, "remapped": _remapped}


def _binary(tm) -> bytes:
    buf = io.BytesIO()
    buf.write(b"\x00B")
    tm.write_binary(buf)
    return buf.getvalue()


@pytest.mark.parametrize("kind", sorted(MODELS))
def test_topology_and_model_bytes_equal_the_jax_writers(kind):
    j, t = MODELS[kind](jtm), MODELS[kind](ttm)
    assert t.topo.is_hmm() == j.topo.is_hmm() == (kind == "bakis")
    jb, tb = io.BytesIO(), io.BytesIO()
    j.topo.write_binary(jb)
    t.topo.write_binary(tb)
    assert tb.getvalue() == jb.getvalue()
    assert t.topo.write_text() == j.topo.write_text()
    assert _binary(t) == _binary(j)
    assert t.write_text() == j.write_text()


@pytest.mark.parametrize("binary", [True, False])
@pytest.mark.parametrize("kind", sorted(MODELS))
def test_model_files_are_read_back_alike(kind, binary, tmp_path):
    """Each package reads the other's file (binary or text, with a trailing
    nnet body after </TransitionModel>) to the same model."""
    j = MODELS[kind](jtm)
    path = str(tmp_path / "final.mdl")
    jtm.write_transition_model(path, j, binary=binary)
    with open(path, "ab") as f:
        f.write(b"<Nnet3> a body the reader leaves unread")
    t = ttm.read_transition_model(path)
    j2 = jtm.read_transition_model(path)
    assert t.tuples == j2.tuples
    np.testing.assert_array_equal(t.log_probs, j2.log_probs)
    for name in ("state2id", "id2state", "id2pdf"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j2, name))
    out = str(tmp_path / "port.mdl")
    ttm.write_transition_model(out, t, binary=binary)
    ref = str(tmp_path / "jax.mdl")
    jtm.write_transition_model(ref, j2, binary=binary)
    assert open(out, "rb").read() == open(ref, "rb").read()


@pytest.mark.parametrize("kind", sorted(MODELS))
def test_every_map_equals_the_jax_model(kind):
    j, t = MODELS[kind](jtm), MODELS[kind](ttm)
    assert (t.num_transition_ids, t.num_pdfs) == (j.num_transition_ids, j.num_pdfs)
    for tid in range(1, j.num_transition_ids + 1):
        assert t.transition_id_to_pdf(tid) == j.transition_id_to_pdf(tid)
        assert t.transition_id_to_phone(tid) == j.transition_id_to_phone(tid)
        assert t.transition_id_to_hmm_state(tid) == j.transition_id_to_hmm_state(tid)
        assert t.is_self_loop(tid) == j.is_self_loop(tid)
        assert t.is_final(tid) == j.is_final(tid)


def _alignments(tm, n, seed):
    """Random transition-id sequences of whole phone instances: each state
    of a phone's entry entered by its forward transition and looped a random
    number of times, in the order of either --reorder convention."""
    rng = np.random.default_rng(seed)
    by = {}
    for tid in range(1, tm.num_transition_ids + 1):
        s = (tm.transition_id_to_phone(tid), tm.transition_id_to_hmm_state(tid))
        by.setdefault(s, {})["loop" if tm.is_self_loop(tid) else "fwd"] = tid
    phones = sorted({p for p, _ in by})
    states = {p: sorted(h for q, h in by if q == p) for p in phones}
    out = {True: {}, False: {}}
    for u in range(n):
        seq = {True: [], False: []}
        for _ in range(int(rng.integers(1, 8))):
            p = int(rng.choice(phones))
            for h in states[p]:
                loops = [by[(p, h)]["loop"]] * int(rng.integers(0, 3))
                seq[True] += [by[(p, h)]["fwd"]] + loops
                seq[False] += loops + [by[(p, h)]["fwd"]]
        for reorder in (True, False):
            out[reorder][f"utt{u}"] = seq[reorder]
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("kind", sorted(MODELS))
def test_ali_to_phones_and_pdfs_equal_the_jax_model(kind, seed):
    j, t = MODELS[kind](jtm), MODELS[kind](ttm)
    alis = _alignments(j, 6, seed)
    for reorder, by_utt in alis.items():
        for utt, ali in by_utt.items():
            got = t.ali_to_phones(ali, reorder=reorder)
            assert got == j.ali_to_phones(ali, reorder=reorder), (utt, reorder)
            assert sum(d for _, d in got) == len(ali)
            assert t.ali_to_pdfs(ali) == j.ali_to_pdfs(ali)
    with pytest.raises(ValueError):
        t.ali_to_phones([j.num_transition_ids + 1])


@pytest.mark.parametrize("name,binary", [("ali.ark", True), ("ali.txt", False),
                                         ("ali.1.gz", True), ("ali.t.gz", False)])
def test_alignment_archives_equal_the_jax_ones(name, binary, tmp_path):
    alis = _alignments(_chain(jtm), 5, 3)[True]
    jp, tp = str(tmp_path / f"j_{name}"), str(tmp_path / f"t_{name}")
    jtm.write_ali_ark(jp, alis, binary=binary)
    ttm.write_ali_ark(tp, alis, binary=binary)
    if name.endswith(".gz"):
        import gzip

        assert gzip.open(tp).read() == gzip.open(jp).read()
    else:
        assert open(tp, "rb").read() == open(jp, "rb").read()
    assert ttm.read_ali_ark(jp) == jtm.read_ali_ark(jp) == alis
    assert ttm.read_ali_ark(tp) == alis
