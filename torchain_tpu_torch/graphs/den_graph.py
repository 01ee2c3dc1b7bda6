"""Denominator-graph compilation: phone LM -> HMM acceptor -> packed arrays.

Behavioral reference: kaldi/src/chain/chain-den-graph.{h,cc}
(`DenominatorGraph`: forward/backward transition CSR arrays, arc list,
`initial_probs_` as the stationary distribution via ~100 power iterations,
`GetNormalizationFst`).  The packed form is `DenGraph` (CSR arc tensors,
by-dst and by-src); ops/den_resident.py re-packs it into the slot-dense
matrix the resident denominator kernels consume, and `DenseDenGraph` is the
state-split Moore form of ops/den_dense.py and ops/den_pallas.py.

The expansion from phone LM to HMM acceptor is epsilon-free by construction:
emissions ride on transitions labeled by the SOURCE topo state's pdf class
(Kaldi HMM semantics), and left-biphone context is tracked directly in the
expanded states (playing the role of C composition); a tree with right
context (a triphone `TiedTree`) takes `_expand_lm_to_hmm_triphone`, which
delays a phone's frames until its successor is chosen.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from torchain_tpu_torch.fstkit import Fst, connect
from torchain_tpu_torch.graphs.topology import BOUNDARY, ChainTopology, ContextTree


# ---------------------------------------------------------------------------
# LM -> HMM expansion
# ---------------------------------------------------------------------------


def expand_lm_to_hmm(
    phone_lm: Fst,
    tree: ContextTree,
    topo: ChainTopology = ChainTopology(),
) -> tuple[Fst, list[int]]:
    """Expand an epsilon-free phone LM into an HMM acceptor over labels
    (pdf_id + 1), also returning per-arc output phone labels (the phone
    ENTERED on phone-entry arcs, 0 elsewhere) in `fst.all_arcs()` order —
    what a decoding graph needs to read phone sequences off a Viterbi path.

    States are of two kinds:
      * boundary states (lm_state, prev_phone): between phones; prev_phone
        is tracked only when the tree is context-dependent.
      * loop states (lm_state_after, phone, left): mid-phone, emitting the
        self-loop pdf; `left` tracked only for untied biphone trees.
    """
    if phone_lm.has_epsilons():
        raise ValueError("phone LM must be epsilon-free")
    rd = getattr(tree, "right_dependent", None)
    if rd is not None and (rd(0) or rd(1)):
        return _expand_lm_to_hmm_triphone(phone_lm, tree, topo)
    need_prev = tree.context_dependent(0) or tree.context_dependent(1)
    need_loop_ctx = tree.context_dependent(1)

    out = Fst()
    olabel_per_state: dict[int, list[int]] = {}  # src state -> olabels
    state_of: dict[tuple, int] = {}

    def state(key: tuple) -> int:
        if key not in state_of:
            state_of[key] = out.add_state()
        return state_of[key]

    start = ("bnd", 0, BOUNDARY)
    assert state(start) == 0
    stack = [start]
    seen = {start}

    def visit(key: tuple) -> int:
        if key not in seen:
            seen.add(key)
            stack.append(key)
        return state(key)

    def add_arc(src: int, label: int, weight: float, dst: int, phone: int):
        out.add_arc(src, label, weight, dst)
        olabel_per_state.setdefault(src, []).append(phone)

    while stack:
        key = stack.pop()
        kind = key[0]
        src = state(key)
        if kind == "bnd":
            _, ls, prev = key
            if phone_lm.is_final(ls):
                out.set_final(src, phone_lm.final(ls))
            for a in phone_lm.arcs(ls):
                q, w, ld = a.label, a.weight, a.dst
                pdf0 = tree.pdf(q, 0, prev)
                loop_key = ("loop", ld, q, prev if need_loop_ctx else BOUNDARY)
                bnd_key = ("bnd", ld, q if need_prev else BOUNDARY)
                add_arc(src, pdf0 + 1, w + topo.log_continue, visit(loop_key), q)
                add_arc(src, pdf0 + 1, w + topo.log_end, visit(bnd_key), q)
        else:
            _, ld, q, left = key
            pdf1 = tree.pdf(q, 1, left)
            bnd_key = ("bnd", ld, q if need_prev else BOUNDARY)
            add_arc(src, pdf1 + 1, topo.log_continue, src, 0)
            add_arc(src, pdf1 + 1, topo.log_end, visit(bnd_key), 0)
    # NOTE: no connect() here — arc/olabel alignment must stay intact; the
    # expansion only creates reachable states, and every state reaches a
    # final state in any LM trained with EOS counts.
    arc_olabel = [
        ol
        for s in range(out.num_states)
        for ol in olabel_per_state.get(s, [])
    ]
    assert len(arc_olabel) == out.num_arcs
    return out, arc_olabel


def _expand_lm_to_hmm_triphone(
    phone_lm: Fst,
    tree,
    topo: ChainTopology = ChainTopology(),
) -> tuple[Fst, list[int]]:
    """Right-context (triphone) variant of expand_lm_to_hmm: pdfs depend on
    (left, phone, right), so a phone's frames can only be emitted once its
    SUCCESSOR is chosen — the role of Kaldi's context FST (C) lookahead in
    HCLG composition, folded directly into the expansion.

    State kinds:
      ("pend", ls, q, prev): committed to phone q (left context `prev`),
        LM already advanced to ls; q's frames not yet emitted.  Expanding
        chooses q's successor arc (or LM-final => right context 0), which
        fixes q's pdfs, emits q's HMM, and lands in the successor's pend.
      ("loop", ls2, q2, q, prev): mid-phone self-loop of q (entered knowing
        successor q2), exiting into ("pend", ls2, q2, q).
      ("final",): utterance-final sink.
    The LM weight of the successor arc rides on q's phone-entry arcs.
    """
    out = Fst()
    olabel_per_state: dict[int, list[int]] = {}
    state_of: dict[tuple, int] = {}

    def state(key: tuple) -> int:
        if key not in state_of:
            state_of[key] = out.add_state()
        return state_of[key]

    stack: list[tuple] = []
    seen: set[tuple] = set()

    def visit(key: tuple) -> int:
        if key not in seen:
            seen.add(key)
            stack.append(key)
        return state(key)

    def add_arc(src: int, label: int, weight: float, dst: int, phone: int):
        out.add_arc(src, label, weight, dst)
        olabel_per_state.setdefault(src, []).append(phone)

    def expand_pend(src: int, ls: int, q: int, prev: int, extra_w: float):
        """Emit phone q's HMM from `src` for every successor choice."""
        for a in phone_lm.arcs(ls):
            q2, w, ls2 = a.label, a.weight + extra_w, a.dst
            pdf0 = tree.pdf(q, 0, prev, q2)
            loop = visit(("loop", ls2, q2, q, prev))
            nxt = visit(("pend", ls2, q2, q))
            add_arc(src, pdf0 + 1, w + topo.log_continue, loop, q)
            add_arc(src, pdf0 + 1, w + topo.log_end, nxt, q)
        if phone_lm.is_final(ls):
            fw = phone_lm.final(ls) + extra_w
            pdf0 = tree.pdf(q, 0, prev, BOUNDARY)
            loop = visit(("loop", -1, BOUNDARY, q, prev))
            fin = visit(("final",))
            add_arc(src, pdf0 + 1, fw + topo.log_continue, loop, q)
            add_arc(src, pdf0 + 1, fw + topo.log_end, fin, q)

    # start state 0: first-phone choice folded in (no epsilon moves)
    assert state(("start",)) == 0
    seen.add(("start",))
    for a in phone_lm.arcs(0):
        expand_pend(0, a.dst, a.label, BOUNDARY, a.weight)

    while stack:
        key = stack.pop()
        kind = key[0]
        src = state(key)
        if kind == "pend":
            _, ls, q, prev = key
            expand_pend(src, ls, q, prev, 0.0)
        elif kind == "loop":
            _, ls2, q2, q, prev = key
            pdf1 = tree.pdf(q, 1, prev, q2)
            if ls2 < 0:  # utterance-final variant
                dst = visit(("final",))
            else:
                dst = visit(("pend", ls2, q2, q))
            add_arc(src, pdf1 + 1, topo.log_continue, src, 0)
            add_arc(src, pdf1 + 1, topo.log_end, dst, 0)
        else:  # "final"
            out.set_final(src, 0.0)

    arc_olabel = [
        ol
        for s in range(out.num_states)
        for ol in olabel_per_state.get(s, [])
    ]
    assert len(arc_olabel) == out.num_arcs
    return out, arc_olabel


def make_den_fst(
    phone_lm: Fst,
    tree: ContextTree,
    topo: ChainTopology = ChainTopology(),
) -> Fst:
    """Denominator HMM acceptor over (pdf_id + 1) labels (see
    expand_lm_to_hmm); output labels dropped, dead states trimmed."""
    fst, _ = expand_lm_to_hmm(phone_lm, tree, topo)
    return connect(fst)


# ---------------------------------------------------------------------------
# Packed formats
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class DenGraph:
    """CSR arc tensors of the denominator HMM (host numpy; moved to device
    by the ops layer).  Mirrors Kaldi `DenominatorGraph`'s ForwardTransitions
    / BackwardTransitions / Transitions / InitialProbs."""

    num_states: int
    num_pdfs: int
    # arcs sorted by dst (alpha recursion gathers over in-arcs)
    in_src: np.ndarray  # int32 [A]
    in_pdf: np.ndarray  # int32 [A]
    in_logw: np.ndarray  # float32 [A]
    in_offsets: np.ndarray  # int32 [S+1]
    # arcs sorted by src (beta recursion gathers over out-arcs)
    out_dst: np.ndarray  # int32 [A]
    out_pdf: np.ndarray  # int32 [A]
    out_logw: np.ndarray  # float32 [A]
    out_offsets: np.ndarray  # int32 [S+1]
    initial_probs: np.ndarray  # float32 [S], stationary distribution

    @property
    def num_arcs(self) -> int:
        return int(self.in_src.shape[0])


@dataclasses.dataclass
class DenseDenGraph:
    """Moore-machine (state-split) dense factorization for ops/den_dense.py and
    ops/den_pallas.py.

    Expanded state e = distinct (dst_state, pdf) pair of the arc set.
      orig_of_exp[e]  original dst state of e
      pdf_of_exp[e]   pdf emitted on entering e
      V[s, e]         prob-space transition mass from original state s into
                      expanded state e (sum of arc probs), EXCLUDING emission
      init_exp[e]     sum over arcs into e of initial_prob[src] * arc_prob
    Padded to multiples of `pad_to` (extra rows/cols are zero).
    """

    num_pdfs: int
    num_orig: int  # padded original-state count
    num_exp: int  # padded expanded-state count
    real_orig: int
    real_exp: int
    V: np.ndarray  # float32 [num_orig, num_exp]
    orig_of_exp: np.ndarray  # int32 [num_exp] (padding rows point at a dump slot)
    pdf_of_exp: np.ndarray  # int32 [num_exp]
    init_exp: np.ndarray  # float32 [num_exp]
    initial_probs: np.ndarray  # float32 [num_orig]


def _stationary_distribution(
    num_states: int,
    arcs: list[tuple[int, int, int, float]],
    num_iters: int = 100,
) -> np.ndarray:
    """Power-iterate x <- normalize(x @ M) from uniform, as Kaldi's
    DenominatorGraph::SetInitialProbs (chain-den-graph.cc) does."""
    src = np.array([a[0] for a in arcs], dtype=np.int64)
    dst = np.array([a[1] for a in arcs], dtype=np.int64)
    prob = np.exp(np.array([a[3] for a in arcs], dtype=np.float64))
    x = np.full(num_states, 1.0 / num_states, dtype=np.float64)
    for _ in range(num_iters):
        y = np.zeros(num_states, dtype=np.float64)
        np.add.at(y, dst, x[src] * prob)
        s = y.sum()
        if s <= 0:
            raise ValueError("transition matrix lost all mass")
        x = y / s
    return x.astype(np.float32)


def _fst_arcs(fst: Fst) -> list[tuple[int, int, int, float]]:
    """(src, dst, pdf, log_weight) tuples; labels are pdf_id+1 on the FST."""
    out = []
    for s, a in fst.all_arcs():
        if a.label <= 0:
            raise ValueError("denominator FST must be epsilon-free")
        out.append((s, a.dst, a.label - 1, a.weight))
    return out


def compile_den_graph(
    den_fst: Fst,
    num_pdfs: int,
    start_boost: float = 0.01,
    initial_probs: np.ndarray | None = None,
) -> DenGraph:
    """Pack the denominator FST into CSR arc tensors + initial probs.

    Final weights are intentionally dropped: the denominator computation
    treats every state as final with probability one
    (kaldi/src/chain/chain-denominator.h semantics).

    `start_boost` mixes a small amount of the true start state into the
    stationary distribution: the boundary-context start state is transient,
    so the pure stationary distribution gives it zero mass, which would make
    the normalization FST reject every utterance-initial supervision chunk
    (Kaldi hits the same failure and silently drops those egs; we keep them
    compatible instead).  Set 0.0 for the pure Kaldi behavior."""
    arcs = _fst_arcs(den_fst)
    S = den_fst.num_states
    A = len(arcs)
    if A == 0:
        raise ValueError("empty denominator FST")
    arr = np.array(arcs, dtype=np.float64)  # columns: src, dst, pdf, logw
    src = arr[:, 0].astype(np.int32)
    dst = arr[:, 1].astype(np.int32)
    pdf = arr[:, 2].astype(np.int32)
    logw = arr[:, 3].astype(np.float32)
    if pdf.max() >= num_pdfs:
        raise ValueError("pdf id exceeds num_pdfs")

    by_dst = np.lexsort((src, dst))
    by_src = np.lexsort((dst, src))
    in_offsets = np.zeros(S + 1, dtype=np.int32)
    np.add.at(in_offsets, dst + 1, 1)
    in_offsets = np.cumsum(in_offsets).astype(np.int32)
    out_offsets = np.zeros(S + 1, dtype=np.int32)
    np.add.at(out_offsets, src + 1, 1)
    out_offsets = np.cumsum(out_offsets).astype(np.int32)

    if initial_probs is not None:
        # explicit initial distribution (e.g. a de Bruijn lift cross-check);
        # start_boost is the caller's responsibility in this case
        initial = np.asarray(initial_probs, dtype=np.float64)
        if initial.shape != (S,):
            raise ValueError("initial_probs shape mismatch")
    else:
        initial = _stationary_distribution(S, arcs).astype(np.float64)
        if start_boost > 0.0:
            initial = (1.0 - start_boost) * initial
            initial[0] += start_boost
    return DenGraph(
        num_states=S,
        num_pdfs=num_pdfs,
        in_src=src[by_dst],
        in_pdf=pdf[by_dst],
        in_logw=logw[by_dst],
        in_offsets=in_offsets,
        out_dst=dst[by_src],
        out_pdf=pdf[by_src],
        out_logw=logw[by_src],
        out_offsets=out_offsets,
        initial_probs=initial.astype(np.float32),
    )


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def make_dense_den_graph(graph: DenGraph, pad_to: int = 128) -> DenseDenGraph:
    """State-split the arc set into the dense Moore factorization.

    Both state axes are padded to multiples of `pad_to` (default 128, the
    JAX package's, so that the two packages' tables are equal)."""
    S = graph.num_states
    # in_* arrays are sorted by dst; recover each arc's dst from the offsets,
    # then form expanded states as the distinct (dst, pdf) pairs
    dst = np.repeat(np.arange(S, dtype=np.int64), np.diff(graph.in_offsets))
    key = dst * graph.num_pdfs + graph.in_pdf.astype(np.int64)
    uniq, exp_of_arc = np.unique(key, return_inverse=True)
    E = uniq.shape[0]
    orig_of_exp = (uniq // graph.num_pdfs).astype(np.int32)
    pdf_of_exp = (uniq % graph.num_pdfs).astype(np.int32)

    prob = np.exp(graph.in_logw.astype(np.float64))
    V = np.zeros((S, E), dtype=np.float64)
    np.add.at(V, (graph.in_src.astype(np.int64), exp_of_arc), prob)
    init_exp = np.zeros(E, dtype=np.float64)
    np.add.at(
        init_exp,
        exp_of_arc,
        graph.initial_probs.astype(np.float64)[graph.in_src] * prob,
    )

    S_pad = _round_up(S, pad_to)
    E_pad = _round_up(E, pad_to)
    V_pad = np.zeros((S_pad, E_pad), dtype=np.float32)
    V_pad[:S, :E] = V
    orig_pad = np.zeros(E_pad, dtype=np.int32)
    orig_pad[:E] = orig_of_exp
    # padding expanded-states point at original state 0 but have zero mass
    pdf_pad = np.zeros(E_pad, dtype=np.int32)
    pdf_pad[:E] = pdf_of_exp
    init_pad = np.zeros(E_pad, dtype=np.float32)
    init_pad[:E] = init_exp
    init_orig_pad = np.zeros(S_pad, dtype=np.float32)
    init_orig_pad[:S] = graph.initial_probs

    return DenseDenGraph(
        num_pdfs=graph.num_pdfs,
        num_orig=S_pad,
        num_exp=E_pad,
        real_orig=S,
        real_exp=E,
        V=V_pad,
        orig_of_exp=orig_pad,
        pdf_of_exp=pdf_pad,
        init_exp=init_pad,
        initial_probs=init_orig_pad,
    )


def make_normalization_fst(den_fst: Fst, initial_probs: np.ndarray) -> Fst:
    """The normalization FST (kaldi/src/chain/chain-den-graph.cc
    `GetNormalizationFst` semantics): the denominator FST with

      * a new start state whose outgoing arcs fold in log(initial_prob) of
        each original state (expanded per-arc to stay epsilon-free), and
      * every original state final with weight 0 (chunks may end mid-HMM).

    Composed onto supervision FSTs so numerator and denominator share the
    same scale (`AddWeightToSupervisionFst` in chain-supervision.cc)."""
    out = Fst()
    out.add_state()  # new start = 0; old state s -> s+1
    out.add_states(den_fst.num_states)
    for s, a in den_fst.all_arcs():
        out.add_arc(s + 1, a.label, a.weight, a.dst + 1)
    for s in range(den_fst.num_states):
        p = float(initial_probs[s])
        if p > 0.0:
            lp = math.log(p)
            for a in den_fst.arcs(s):
                out.add_arc(0, a.label, lp + a.weight, a.dst + 1)
        out.set_final(s + 1, 0.0)
    return out
