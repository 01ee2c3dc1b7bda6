"""Token-passing Viterbi decoder over the phone-level decoding graph (a
copy of torchain_tpu/eval/decoder.py, which imports no JAX).

Behavioral reference: Kaldi's latgen-faster-mapped as used by chain recipes
(SURVEY.md section 3.4): beam decoding over HCLG with acoustic scale 1.0
and no prior division, reading the best path's output labels.  Scope per
SURVEY.md section 7 hard-part 4: best-path decoding (no lattices yet) over
the lexicon-free phone graph (words == phones for the current corpora);
vectorized numpy host implementation with per-frame beam pruning.
A C++ drop-in for large graphs lives in csrc/decoder.cc (same packed
format), loaded by eval/native.py.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from torchain_tpu_torch.fstkit import Fst
from torchain_tpu_torch.fstkit.fst import NEG_INF
from torchain_tpu_torch.graphs.den_graph import expand_lm_to_hmm
from torchain_tpu_torch.graphs.topology import ChainTopology, ContextTree


@dataclasses.dataclass
class DecodingGraph:
    """Packed arc tensors, sorted by dst (for per-frame segment max)."""

    num_states: int
    num_pdfs: int
    src: np.ndarray  # int32 [A]
    dst: np.ndarray  # int32 [A]
    pdf: np.ndarray  # int32 [A]
    weight: np.ndarray  # float32 [A] graph score (LM + transition)
    olabel: np.ndarray  # int32 [A] phone emitted on entry arcs (0 = none)
    final_logw: np.ndarray  # float32 [S] (-inf = non-final)
    dst_offsets: np.ndarray  # int32 [S+1] segment offsets into arc arrays
    #: input-epsilon (non-emitting) arcs, present when the graph came from
    #: a real Kaldi HCLG (word-boundary / LM-backoff arcs).  Sorted by the
    #: topological LEVEL of their source within the eps subgraph so one
    #: level-ordered relaxation sweep per frame is exact; eps_levels holds
    #: the [L+1] arc-range offsets per level.  Empty for the (eps-free)
    #: graphs this repo compiles itself.
    eps_src: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.int32))
    eps_dst: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.int32))
    eps_weight: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.float32))
    eps_olabel: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.int32))
    eps_levels: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(1, np.int32))

    @property
    def num_eps(self) -> int:
        return int(self.eps_src.shape[0])


def _pack_eps_arcs(S: int, eps: list[tuple[int, int, float, int]]):
    """Topologically level-order the input-epsilon subgraph.  Raises on a
    pure-epsilon cycle (a zero-frame loop; Kaldi HCLGs are eps-acyclic
    because LM backoff strictly lowers the grammar order)."""
    if not eps:
        return (np.zeros(0, np.int32), np.zeros(0, np.int32),
                np.zeros(0, np.float32), np.zeros(0, np.int32),
                np.zeros(1, np.int32))
    states = sorted({e[0] for e in eps} | {e[1] for e in eps})
    # Kahn longest-path levels over the eps subgraph
    out_arcs: dict[int, list[int]] = {}
    indeg: dict[int, int] = {st: 0 for st in states}
    for i, (a, b, _w, _o) in enumerate(eps):
        out_arcs.setdefault(a, []).append(i)
        indeg[b] += 1
    level = {st: 0 for st in states}
    queue = [st for st in states if indeg[st] == 0]
    seen = 0
    while queue:
        st = queue.pop()
        seen += 1
        for i in out_arcs.get(st, ()):  # noqa: B909
            b = eps[i][1]
            level[b] = max(level[b], level[st] + 1)
            indeg[b] -= 1
            if indeg[b] == 0:
                queue.append(b)
    if seen != len(states):
        raise ValueError(
            "decoding graph has a pure input-epsilon cycle; remove it "
            "(fstrmepsilon) before packing"
        )
    order = sorted(range(len(eps)), key=lambda i: level[eps[i][0]])
    esrc = np.array([eps[i][0] for i in order], np.int32)
    edst = np.array([eps[i][1] for i in order], np.int32)
    ew = np.array([eps[i][2] for i in order], np.float32)
    eol = np.array([eps[i][3] for i in order], np.int32)
    lvls = [level[eps[i][0]] for i in order]
    L = (lvls[-1] + 1) if lvls else 0
    offs = np.zeros(L + 1, np.int32)
    for lv in lvls:
        offs[lv + 1] += 1
    offs = np.cumsum(offs).astype(np.int32)
    return esrc, edst, ew, eol, offs


def _relax_eps(graph: "DecodingGraph", tokens: np.ndarray,
               eps_bp: "np.ndarray | None" = None) -> np.ndarray:
    """One exact level-ordered relaxation of the eps arcs (tropical).
    Mutates `tokens`; records the improving arc id per state in `eps_bp`
    when given (else -1 rows untouched)."""
    E = graph.num_eps
    if not E:
        return tokens
    offs = graph.eps_levels
    big = E + 1
    for li in range(len(offs) - 1):
        lo, hi = int(offs[li]), int(offs[li + 1])
        if lo == hi:
            continue
        src = graph.eps_src[lo:hi]
        dst = graph.eps_dst[lo:hi]
        sc = tokens[src] + graph.eps_weight[lo:hi]
        seg = np.full(tokens.shape[0], NEG_INF)
        np.maximum.at(seg, dst, sc)
        improved = seg > tokens
        if not improved.any():
            continue
        if eps_bp is not None:
            cand = np.where(sc == seg[dst], np.arange(lo, hi), big)
            argm = np.full(tokens.shape[0], big, np.int64)
            np.minimum.at(argm, dst, cand)
            eps_bp[improved] = argm[improved].astype(np.int32)
        tokens[improved] = seg[improved]
    return tokens


def pack_decoding_graph(
    fst: Fst,
    olabels: list[int],
    num_pdfs: int,
    weight_scale: float = 1.0,
    allow_eps: bool = False,
) -> DecodingGraph:
    """Pack an HMM acceptor over (pdf_id + 1) labels with aligned per-arc
    output labels into the dst-sorted arc tensors the decoders consume.

    With allow_eps=True, label-0 arcs become the graph's non-emitting arc
    set (real Kaldi HCLGs carry them; see DecodingGraph.eps_src) instead
    of raising."""
    arcs = []
    eps = []
    for i, (s, a) in enumerate(fst.all_arcs()):
        if a.label == 0:
            if not allow_eps:
                raise ValueError(
                    "epsilon input arc in decoding graph; pass "
                    "allow_eps=True (real-HCLG path)"
                )
            eps.append((s, a.dst, a.weight * weight_scale, olabels[i]))
            continue
        arcs.append((s, a.dst, a.label - 1, a.weight * weight_scale, olabels[i]))
    if not arcs:
        raise ValueError("decoding graph has no emitting arcs")
    arr = np.array(arcs, dtype=np.float64)
    order = np.lexsort((arr[:, 0], arr[:, 1]))  # sort by dst, then src
    arr = arr[order]
    S = fst.num_states
    dst = arr[:, 1].astype(np.int32)
    offsets = np.zeros(S + 1, dtype=np.int32)
    np.add.at(offsets, dst + 1, 1)
    offsets = np.cumsum(offsets).astype(np.int32)
    final = np.full(S, NEG_INF, dtype=np.float32)
    for s in range(S):
        if fst.is_final(s):
            final[s] = fst.final(s) * weight_scale
    return DecodingGraph(
        num_states=S,
        num_pdfs=num_pdfs,
        src=arr[:, 0].astype(np.int32),
        dst=dst,
        pdf=arr[:, 2].astype(np.int32),
        weight=arr[:, 3].astype(np.float32),
        olabel=arr[:, 4].astype(np.int32),
        final_logw=final,
        dst_offsets=offsets,
        **dict(
            zip(
                ("eps_src", "eps_dst", "eps_weight", "eps_olabel", "eps_levels"),
                _pack_eps_arcs(S, eps),
            )
        ),
    )


def make_decoding_graph(
    phone_lm: Fst,
    tree: ContextTree,
    topo: ChainTopology = ChainTopology(),
    lm_scale: float = 1.0,
) -> DecodingGraph:
    """Phone-level HCLG-equivalent: decoding LM expanded through context +
    topology, with phone output labels on entry arcs."""
    fst, olabels = expand_lm_to_hmm(phone_lm, tree, topo)
    return pack_decoding_graph(fst, olabels, tree.num_pdfs, weight_scale=lm_scale)


def make_word_decoding_graph(
    word_lm: Fst,
    lexicon,
    tree: ContextTree,
    topo: ChainTopology = ChainTopology(),
    lm_scale: float = 1.0,
) -> DecodingGraph:
    """Word-level HCLG (latgen-faster-mapped graph role, SURVEY section 3.4):
    grammar + lexicon + tree + chain topology compiled epsilon-free by
    graphs.hclg.make_hclg; output labels are WORD ids, so viterbi_decode /
    lattice_decode / lattice_nbest produce word sequences directly."""
    from torchain_tpu_torch.graphs.hclg import make_hclg

    fst, olabels = make_hclg(word_lm, lexicon, tree, topo, lm_scale=lm_scale)
    return pack_decoding_graph(fst, olabels, tree.num_pdfs)


def hclg_decoding_graph(
    fst: Fst,
    olabels: list[int],
    trans_model,
    num_pdfs: int | None = None,
    weight_scale: float = 1.0,
) -> DecodingGraph:
    """Pack a REAL Kaldi HCLG for the decoders (nnet3-latgen-faster graph
    role).  `fst`/`olabels` come from `fstkit.read_openfst("HCLG.fst")`
    (input labels = TRANSITION-IDS, output labels = word ids, weights
    already in log-prob convention); `trans_model` is the
    `graphs.transition_model.TransitionModel` from final.mdl.  Input
    labels map to pdf+1 through the TransitionModel
    (TransitionIdToPdfFast role); ilabel-0 arcs become the non-emitting
    arc set (word-boundary / LM-backoff arcs — relaxed exactly by the
    numpy decoder).  Self-loops are already present in a Kaldi HCLG
    (add-self-loops), so the graph packs as-is."""
    id2pdf = np.asarray(trans_model.id2pdf, np.int64)
    out = Fst()
    out.add_states(fst.num_states)
    for s_, a in fst.all_arcs():
        if a.label == 0:
            out.add_arc(s_, 0, a.weight, a.dst, a.weight2)
        else:
            if a.label >= id2pdf.shape[0]:
                raise ValueError(
                    f"HCLG ilabel {a.label} exceeds the transition model's "
                    f"{trans_model.num_transition_ids} transition ids"
                )
            out.add_arc(
                s_, int(id2pdf[a.label]) + 1, a.weight, a.dst, a.weight2
            )
    for s_ in range(fst.num_states):
        if fst.is_final(s_):
            out.set_final(s_, fst.final(s_), fst.final2(s_))
    return pack_decoding_graph(
        out,
        olabels,
        num_pdfs if num_pdfs is not None else trans_model.num_pdfs,
        weight_scale=weight_scale,
        allow_eps=True,
    )


def viterbi_decode(
    graph: DecodingGraph,
    loglikes: np.ndarray,  # [T, P] chain-head outputs (acoustic scale 1.0)
    beam: float = 16.0,
    use_final: bool = True,
    backend: str = "auto",  # auto | native | numpy
    phone_bonus: float = 0.0,
    max_active: int = 7000,
) -> tuple[list[int], float]:
    """Best-path decode; returns (phone_sequence, path_score).

    backend="auto" uses the C++ active-token core (csrc/decoder.cc, built
    on demand; only states alive within the beam are expanded, `max_active`
    caps the frontier exactly as latgen-faster-mapped's --max-active); it
    runs this vectorized numpy token-passing implementation only where no
    C++ compiler is found (a failed build raises) or where the core
    reports a failure.  The numpy path remains the tested reference: each frame scores every arc, takes
    a segment max per destination state (argmax kept as backpointer), then
    prunes tokens outside `beam` of the frame-best.

    `phone_bonus` is added to every phone-emitting arc (the word-insertion
    -penalty knob of Kaldi scoring, negated): positive values counteract
    deletion-dominated error patterns.
    """
    if phone_bonus != 0.0:
        graph = dataclasses.replace(
            graph,
            weight=(graph.weight + phone_bonus * (graph.olabel > 0)).astype(
                np.float32
            ),
            eps_weight=(
                graph.eps_weight + phone_bonus * (graph.eps_olabel > 0)
            ).astype(np.float32),
        )
    if backend in ("auto", "native"):
        from torchain_tpu_torch.eval.native import native_viterbi, native_viterbi_active

        out = native_viterbi_active(
            graph, np.asarray(loglikes, np.float32), beam, max_active, use_final
        )
        if out is None and graph.num_eps == 0:
            # the dense fallback core predates eps arcs
            out = native_viterbi(
                graph, np.asarray(loglikes, np.float32), beam, use_final
            )
        if out is not None:
            return out
        if backend == "native":
            raise RuntimeError(
                "native decoder unavailable: no C++ compiler found, or the "
                "core reported a failure"
            )
    T, P = loglikes.shape
    if P != graph.num_pdfs:
        raise ValueError("pdf dim mismatch")
    S = graph.num_states
    A = graph.src.shape[0]
    off = graph.dst_offsets
    seg_valid = np.diff(off) > 0  # states with in-arcs

    tokens = np.full(S, NEG_INF, dtype=np.float64)
    tokens[0] = 0.0
    backptr = np.zeros((T, S), dtype=np.int32)
    has_eps = graph.num_eps > 0
    # eps_bp[t+1] = improving non-emitting arc per state AFTER frame t's
    # emitting update (row 0 = the initial closure from the start state)
    eps_bp = np.full((T + 1, S), -1, np.int32) if has_eps else None
    if has_eps:
        _relax_eps(graph, tokens, eps_bp[0])
    arange_a = np.arange(A)

    for t in range(T):
        scores = tokens[graph.src] + graph.weight + loglikes[t, graph.pdf]
        # segment max + argmax by dst
        seg_max = np.full(S, NEG_INF)
        np.maximum.at(seg_max, graph.dst, scores)
        is_best = scores == seg_max[graph.dst]
        # first best arc per segment
        cand = np.where(is_best, arange_a, A)
        seg_arg = np.full(S, A, dtype=np.int64)
        np.minimum.at(seg_arg, graph.dst, cand)
        new_tokens = seg_max
        backptr[t] = np.where(seg_arg < A, seg_arg, 0).astype(np.int32)
        if has_eps:
            _relax_eps(graph, new_tokens, eps_bp[t + 1])
        # beam prune
        best = new_tokens.max()
        new_tokens = np.where(new_tokens >= best - beam, new_tokens, NEG_INF)
        tokens = new_tokens

    final_scores = tokens + (graph.final_logw if use_final else 0.0)
    if not np.isfinite(final_scores.max()):
        final_scores = tokens  # no reachable final: fall back
    state = int(np.argmax(final_scores))
    score = float(final_scores[state])
    phones_rev: list[int] = []

    def unwind_eps(state: int, row: int) -> int:
        while has_eps and eps_bp[row, state] >= 0:
            arc = int(eps_bp[row, state])
            if graph.eps_olabel[arc] > 0:
                phones_rev.append(int(graph.eps_olabel[arc]))
            state = int(graph.eps_src[arc])
        return state

    for t in range(T - 1, -1, -1):
        state = unwind_eps(state, t + 1)
        arc = int(backptr[t, state])
        if graph.olabel[arc] > 0:
            phones_rev.append(int(graph.olabel[arc]))
        state = int(graph.src[arc])
    unwind_eps(state, 0)
    return phones_rev[::-1], score
