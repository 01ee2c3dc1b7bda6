"""The port's decoders on the CPU against the JAX package's: eval/wer.py,
the packed decoding graphs (eval/decoder.py over graphs/den_graph.py and
graphs/hclg.py), viterbi_decode with the NumPy reference and with the
native core (the port builds its own copy of csrc/decoder.cc into
torchain_tpu_torch/build/), and hclg_decoding_graph over a stand-in
transition model.

Both packages run the same NumPy and the same C++ on the same inputs, made
from a seed: graphs, hypotheses and lattices are held exactly, Viterbi
scores to 1e-6 relative.

The JAX package builds its native decoder with `make -C csrc` at first use,
straight onto the library's path, and gives it up for the rest of the
process once a load fails; the JAX package's own tests build it so, and a
test process that loads it while another links it skips the native tests.
So that no port test is one more writer of that path, every port test file
that runs the JAX package's native backend first takes
`jax_native_decoder()`: it compiles the JAX package's decoder source into a
file of its own in the temporary directory (under a lock shared by the test
processes, written under a private name and renamed into place), points
the JAX loader at that file, re-arms it where this process has given up,
and loads it.  This module also calls it when it is collected, so that the
loader of every test process holds the library before any test runs.
"""

import dataclasses
import fcntl
import hashlib
import os
import pathlib
import struct
import subprocess
import sys
import tempfile

import numpy as np
import pytest

pytest.importorskip("jax")

from torchain_tpu.eval import decoder as jdec
import torchain_tpu.eval.wer  # noqa: F401  (the module, which eval's `wer` shadows)
from torchain_tpu.fstkit import Fst as JFst
from torchain_tpu.graphs import hclg as jhclg
from torchain_tpu.graphs.phone_lm import PhoneLmOptions as JLmOpts
from torchain_tpu.graphs.phone_lm import estimate_phone_lm as jestimate
from torchain_tpu.graphs.topology import ContextTree as JTree
from torchain_tpu_torch.eval import decoder as tdec
from torchain_tpu_torch.eval import native as tnative
import torchain_tpu_torch.eval.wer  # noqa: F401
from torchain_tpu_torch.fstkit import Fst as TFst
from torchain_tpu_torch.graphs import hclg as thclg
from torchain_tpu_torch.graphs.phone_lm import PhoneLmOptions as TLmOpts
from torchain_tpu_torch.graphs.phone_lm import estimate_phone_lm as p_estimate
from torchain_tpu_torch.graphs.topology import ContextTree as TTree

#: how long `jax_native_decoder` waits for the JAX package's native library
JAX_NATIVE_WAIT_S = 120.0
#: csrc/Makefile's CXXFLAGS and LDFLAGS
JAX_DECODER_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall", "-shared")


def _elf_complete(path) -> bool:
    """Whether `path` is a 64-bit ELF file that holds all its headers say it
    holds: the program and section header tables and every segment."""
    try:
        data = path.read_bytes()
    except OSError:
        return False
    if len(data) < 64 or data[:4] != b"\x7fELF":
        return False
    phoff, shoff = struct.unpack_from("<QQ", data, 32)
    phentsize, phnum, shentsize, shnum = struct.unpack_from("<HHHH", data, 54)
    end = max(phoff + phentsize * phnum, shoff + shentsize * shnum)
    if end > len(data):
        return False
    for i in range(phnum):
        _, _, offset, _, _, filesz = struct.unpack_from("<IIQQQQ", data, phoff + i * phentsize)
        end = max(end, offset + filesz)
    return end <= len(data)


def jax_native_decoder(wait_s: float = JAX_NATIVE_WAIT_S):
    """The JAX package's native decoder library, loaded in this process.

    Where this process's JAX loader holds none, compiles the JAX package's
    `csrc/decoder.cc` with the flags of `csrc/Makefile` into
    `torchain_tpu_jax_decoder_<source digest>.so` in the temporary
    directory, unless a whole one is there: under an exclusive
    `fcntl.flock` on a file beside it, into a name of this process's own,
    then renamed into place, so that no process maps a half-written
    library.  The JAX loader's path is then that file; its mark of a failed
    load is cleared and it loads the library (a compile that has not ended
    within `wait_s` seconds, or a load that fails, is an AssertionError)."""
    from torchain_tpu.eval import native as jnative

    if jnative._lib is not None:
        return jnative._lib
    src = jnative._CSRC / "decoder.cc"
    tmp = tempfile.gettempdir()
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    so = pathlib.Path(tmp, f"torchain_tpu_jax_decoder_{digest}.so")
    with open(os.path.join(tmp, "torchain_tpu_native_decoder.lock"), "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            if not _elf_complete(so):
                part = f"{so}.{os.getpid()}.part"
                try:
                    subprocess.run(["g++", *JAX_DECODER_FLAGS, "-o", part, str(src)],
                                   check=True, capture_output=True, timeout=wait_s)
                except (OSError, subprocess.SubprocessError) as e:
                    err = (getattr(e, "stderr", None) or b"")[-2000:].decode(errors="replace")
                    raise AssertionError(f"the JAX package's native decoder did not compile:"
                                         f" {e}\n{err}") from e
                os.replace(part, so)
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)
    jnative._SO, jnative._load_failed = so, False
    lib = jnative.get_lib()
    if lib is None:
        raise AssertionError(f"the JAX package's native decoder ({so}) did not load")
    return lib


# at this module's collection, in every test process: the JAX package's
# tests/test_native_lattice.py calls its loader when it is collected, so
# every process of a parallel run has run `make -C csrc` onto one file
# before any test starts, and a process that mapped that file half-written
# has given the library up; its later native tests would skip.  A compile
# or load that fails here stops no collection: each native test calls the
# helper again and fails with the reason
try:
    jax_native_decoder()
except AssertionError:
    pass


@pytest.fixture(scope="module", autouse=True)
def _jax_native():
    return jax_native_decoder()


jwer = sys.modules["torchain_tpu.eval.wer"]
twer = sys.modules["torchain_tpu_torch.eval.wer"]
GRAPH_FIELDS = [f.name for f in dataclasses.fields(jdec.DecodingGraph)]


def _sentences(seed, n, lo, hi, vocab):
    rng = np.random.default_rng(seed)
    return [[int(x) for x in rng.integers(1, vocab + 1, size=int(rng.integers(lo, hi)))]
            for _ in range(n)]


def _lexicon(seed, vocab, num_phones, sil_phone=0):
    rng = np.random.default_rng(seed)
    prons = {w: [tuple(int(q) for q in rng.integers(1, num_phones + 1,
                                                      size=int(rng.integers(1, 4))))]
             for w in range(1, vocab + 1)}
    prons[2].append((1, 2))  # a second pronunciation
    return prons, sil_phone


def phone_graphs(seed=0, num_phones=5, context_width=1, lm_order=2):
    """The same phone decoding graph built by each package."""
    sents = _sentences(seed, 40, 3, 8, num_phones)
    out = []
    for est, opts, tree, dec in ((jestimate, JLmOpts, JTree, jdec),
                                 (p_estimate, TLmOpts, TTree, tdec)):
        lm = est(sents, opts(ngram_order=lm_order, num_extra_lm_states=40))
        t = tree(num_phones, context_width=context_width)
        out.append(dec.make_decoding_graph(lm, t))
    return out


def word_graphs(seed=0, num_phones=5, vocab=6, context_width=1, sil_phone=0):
    sents = _sentences(seed + 100, 30, 2, 6, vocab)
    prons, sil = _lexicon(seed, vocab, num_phones, sil_phone)
    out = []
    for est, opts, tree, dec, hc in ((jestimate, JLmOpts, JTree, jdec, jhclg),
                                     (p_estimate, TLmOpts, TTree, tdec, thclg)):
        g = est(sents, opts(ngram_order=2, num_extra_lm_states=40))
        lex = hc.Lexicon(prons=prons, sil_phone=sil, sil_prob=0.3)
        out.append((g, lex, tree(num_phones, context_width=context_width), dec, hc))
    return out


def _eps_arcs(seed, S=12, P=4):
    """A random graph over P pdfs with emitting arcs and an acyclic set of
    input-epsilon arcs (chains included), as a Kaldi HCLG carries them."""
    rng = np.random.default_rng(seed)
    arcs = [(0, int(rng.integers(1, P + 1)), -0.1, 1, 0)]
    for s in range(S):
        for _ in range(3):
            arcs.append((s, int(rng.integers(1, P + 1)), float(-rng.uniform(0, 2)),
                         int(rng.integers(0, S)), int(rng.integers(0, 3)) * 3))
    for _ in range(S):
        a, b = sorted(int(x) for x in rng.choice(S, size=2, replace=False))
        arcs.append((a, 0, float(-rng.uniform(0, 1)), b, int(rng.integers(0, 2)) * 7))
    finals = {int(s): float(-rng.uniform(0, 1)) for s in rng.choice(S, size=3, replace=False)}
    return arcs, finals


def _fst(cls, arcs, finals, S):
    f = cls()
    f.add_states(S)
    for s, lab, w, d, _ in arcs:
        f.add_arc(s, lab, w, d)
    for s, w in finals.items():
        f.set_final(s, w)
    return f, [a[4] for a in arcs]


def eps_graphs(seed=0, S=12, P=4):
    arcs, finals = _eps_arcs(seed, S, P)
    return [dec.pack_decoding_graph(*_fst(cls, arcs, finals, S), P, allow_eps=True)
            for cls, dec in ((JFst, jdec), (TFst, tdec))]


def assert_same_graph(a, b):
    for name in GRAPH_FIELDS:
        x, y = getattr(a, name), getattr(b, name)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and np.array_equal(x, y), name
        else:
            assert x == y, name


def loglikes(seed, T, P, scale=2.0):
    return (np.random.default_rng(seed).normal(size=(T, P)) * scale).astype(np.float32)


def test_native_library_builds_into_the_port():
    lib = tnative.get_lib()
    assert lib is not None
    assert tnative.LIBRARY.parent.name == "build"
    assert tnative.LIBRARY.parent.parent.name == "torchain_tpu_torch"
    assert tnative.LIBRARY.exists()
    assert lib.tt_abi_version() == 3


@pytest.mark.parametrize("seed", range(6))
def test_edit_distance_and_wer(seed):
    rng = np.random.default_rng(seed)
    refs = [list(rng.integers(0, 5, size=int(rng.integers(0, 9)))) for _ in range(10)]
    hyps = [list(rng.integers(0, 5, size=int(rng.integers(0, 9)))) for _ in range(10)]
    for r, h in zip(refs, hyps):
        assert twer.edit_distance(r, h) == jwer.edit_distance(r, h)
    assert twer.wer(refs, hyps) == jwer.wer(refs, hyps)
    with pytest.raises(ValueError):
        twer.wer(refs, hyps[:-1])


@pytest.mark.parametrize("context_width", [1, 2])
def test_make_decoding_graph_equals_jax(context_width):
    j, t = phone_graphs(seed=context_width, context_width=context_width)
    assert_same_graph(j, t)


@pytest.mark.parametrize("context_width,sil_phone", [(1, 0), (1, 5), (2, 0), (2, 5)])
def test_make_hclg_and_word_graph_equal_jax(context_width, sil_phone):
    (jg, jlex, jtree, _, jhc), (tg, tlex, ttree, _, thc) = word_graphs(
        seed=context_width, context_width=context_width, sil_phone=sil_phone)
    jf, jol = jhc.make_hclg(jg, jlex, jtree, lm_scale=0.8)
    tf, tol = thc.make_hclg(tg, tlex, ttree, lm_scale=0.8)
    assert tol == jol
    assert tf.num_states == jf.num_states
    assert [(s, a.label, a.weight, a.dst) for s, a in tf.all_arcs()] == [
        (s, a.label, a.weight, a.dst) for s, a in jf.all_arcs()]
    assert [tf.final(s) for s in range(tf.num_states)] == [
        jf.final(s) for s in range(jf.num_states)]
    assert_same_graph(jdec.make_word_decoding_graph(jg, jlex, jtree),
                      tdec.make_word_decoding_graph(tg, tlex, ttree))


def test_eps_graph_packing_equals_jax():
    j, t = eps_graphs(seed=3)
    assert t.num_eps > 0 and len(t.eps_levels) > 2  # an eps chain
    assert_same_graph(j, t)


def _graphs(kind):
    if kind == "phone":
        return phone_graphs(seed=5)
    if kind == "biphone":
        return phone_graphs(seed=6, context_width=2)
    if kind == "word":
        (jg, jlex, jtree, *_), (tg, tlex, ttree, *_) = word_graphs(seed=7, sil_phone=5)
        return (jdec.make_word_decoding_graph(jg, jlex, jtree),
                tdec.make_word_decoding_graph(tg, tlex, ttree))
    return eps_graphs(seed=8)


@pytest.mark.parametrize("kind", ["phone", "biphone", "word", "eps"])
@pytest.mark.parametrize("backend", ["numpy", "native"])
@pytest.mark.parametrize("bonus", [0.0, 0.7])
def test_viterbi_decode_equals_jax(kind, backend, bonus):
    j, t = _graphs(kind)
    for seed in range(3):
        y = loglikes(seed, 25, t.num_pdfs)
        for beam in (6.0, 16.0):
            jh, js = jdec.viterbi_decode(j, y, beam=beam, backend=backend, phone_bonus=bonus)
            th, ts = tdec.viterbi_decode(t, y, beam=beam, backend=backend, phone_bonus=bonus)
            assert th == jh
            assert ts == pytest.approx(js, rel=1e-6)


@pytest.mark.parametrize("kind", ["phone", "word", "eps"])
def test_viterbi_max_active_binding_equals_jax(kind):
    j, t = _graphs(kind)
    y = loglikes(11, 30, t.num_pdfs, scale=0.5)
    wide = tdec.viterbi_decode(t, y, beam=1e9, backend="native", max_active=100000)
    bound = tdec.viterbi_decode(t, y, beam=1e9, backend="native", max_active=2)
    for got, cap in ((wide, 100000), (bound, 2)):
        jh, js = jdec.viterbi_decode(j, y, beam=1e9, backend="native", max_active=cap)
        assert got[0] == jh
        assert got[1] == pytest.approx(js, rel=1e-6)
    # the cap binds: the frontier of 2 finds a worse path than the full one
    assert bound[1] < wide[1]


def test_native_agrees_with_numpy_on_the_port():
    _, t = _graphs("word")
    for seed in range(4):
        y = loglikes(seed, 30, t.num_pdfs)
        nh, ns = tdec.viterbi_decode(t, y, beam=16.0, backend="native", max_active=100000)
        ph, ps = tdec.viterbi_decode(t, y, beam=16.0, backend="numpy")
        assert nh == ph
        assert ns == pytest.approx(ps, rel=1e-5)


@dataclasses.dataclass
class StandInTransitionModel:
    """What hclg_decoding_graph reads of a Kaldi TransitionModel: the
    pdf of each transition id (id 0 unused)."""

    id2pdf: list
    num_pdfs: int

    @property
    def num_transition_ids(self):
        return len(self.id2pdf) - 1


def test_hclg_decoding_graph_equals_jax():
    rng = np.random.default_rng(4)
    P, n_tid, S = 4, 9, 10
    tm = StandInTransitionModel(id2pdf=[-1] + [int(x) for x in rng.integers(0, P, size=n_tid)],
                                num_pdfs=P)
    arcs, finals = _eps_arcs(9, S, n_tid)
    graphs = [dec.hclg_decoding_graph(*_fst(cls, arcs, finals, S), tm, weight_scale=0.9)
              for cls, dec in ((JFst, jdec), (TFst, tdec))]
    assert graphs[1].num_pdfs == P and graphs[1].num_eps > 0
    assert_same_graph(*graphs)
    y = loglikes(2, 12, P)
    for backend in ("numpy", "native"):
        jh, js = jdec.viterbi_decode(graphs[0], y, backend=backend)
        th, ts = tdec.viterbi_decode(graphs[1], y, backend=backend)
        assert th == jh and ts == pytest.approx(js, rel=1e-6)
    bad = [(s, lab + n_tid if lab else 0, w, d, o) for s, lab, w, d, o in arcs]
    with pytest.raises(ValueError, match="transition ids"):
        tdec.hclg_decoding_graph(*_fst(TFst, bad, finals, S), tm)
