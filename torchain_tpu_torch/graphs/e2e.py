"""End-to-end (flat-start) supervision: transcripts without alignments.

Behavioral reference: kaldi/src/chain/chain-generic-numerator.{h,cc}
(`GenericNumeratorComputation`) and the e2e supervision path
(`Supervision::e2e_fsts`, used by Kaldi's flat-start LF-MMI recipes,
Hadian et al. 2018): the numerator graph is the transcript's HMM with
self-loops — ANY duration assignment is allowed — composed with the
normalization FST.  Unlike tolerance lattices these graphs are cyclic, so
states do not map to frames; scoring runs a full alpha/beta over (T x
states) in ops/num_e2e.py.

This removes the alignment bootstrap dependency: training can start from
transcripts alone.  Copy of torchain_tpu/graphs/e2e.py (which imports no
JAX): for the same transcript, tree and normalization FST it yields the
same tables.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from torchain_tpu_torch.fstkit import Fst, compose, connect
from torchain_tpu_torch.fstkit.fst import NEG_INF
from torchain_tpu_torch.graphs.topology import BOUNDARY, ChainTopology, ContextTree


def transcript_to_e2e_fst(
    phones: list[int],
    tree: ContextTree,
    topo: ChainTopology = ChainTopology(),
    left_context_phone: int = BOUNDARY,
) -> Fst:
    """Unweighted linear HMM over the transcript with self-loops — any
    duration assignment >= 1 frame per phone is accepted.  Kaldi e2e
    supervision FSTs are unweighted; the denominator scale enters via the
    normalization-FST composition."""
    if not phones:
        raise ValueError("empty transcript")
    fst = Fst()
    start = fst.add_state()
    loops = [fst.add_state() for _ in phones]
    left = [left_context_phone] + phones[:-1]
    right = phones[1:] + [0]
    for i, p in enumerate(phones):
        pdf0 = tree.pdf(p, 0, left[i], right[i])
        pdf1 = tree.pdf(p, 1, left[i], right[i])
        src = start if i == 0 else loops[i - 1]
        fst.add_arc(src, pdf0 + 1, 0.0, loops[i])
        fst.add_arc(loops[i], pdf1 + 1, 0.0, loops[i])
    fst.set_final(loops[-1], 0.0)
    return fst


def make_e2e_supervision_fst(
    phones: list[int],
    tree: ContextTree,
    norm_fst: Fst,
    topo: ChainTopology = ChainTopology(),
    left_context_phone: int = BOUNDARY,
    norm_ready: bool = False,
) -> Fst:
    """Transcript HMM composed with the normalization FST (num/den scale
    matching).  NOTE: Kaldi supervision FSTs are unweighted and the
    topology probabilities live in the den graph only; we keep the
    unweighted convention (weights come from the composition) to match
    `AddWeightToSupervisionFst` semantics.  norm_ready declares norm_fst
    already eps-free + arcsorted (E2eChainDataset sorts it once)."""
    sup = transcript_to_e2e_fst(phones, tree, topo, left_context_phone)
    out = compose(sup, norm_fst, b_ready=norm_ready)
    out = connect(out)
    if out.num_states == 0:
        raise ValueError(
            "e2e supervision composition is empty — denominator graph does "
            "not accept this transcript (a gap in the phone LM's coverage)"
        )
    return out


@dataclasses.dataclass
class E2eSupervision:
    """Packed cyclic numerator graph(s).  Arc tables are constant over
    time (unlike the frame-local Supervision packing): in_src/in_pdf/
    in_logw [S, K] (or [B, S, K] batched) with -1/-inf padding;
    state 0 is initial; final_logw [S]."""

    num_frames: int
    num_pdfs: int
    max_states: int
    max_arcs: int
    #: scalar for one sequence; float32 [B] after pad_and_stack_e2e
    weight: "float | np.ndarray"
    in_src: np.ndarray
    in_pdf: np.ndarray
    in_logw: np.ndarray
    final_logw: np.ndarray
    #: optional per-frame derivative weights ([B, T] batched); cegs
    #: interchange only (deriv_weights semantics)
    frame_weights: "np.ndarray | None" = None


def compile_e2e_supervision(
    fst: Fst,
    num_frames: int,
    num_pdfs: int,
    weight: float = 1.0,
    max_states: int | None = None,
    max_arcs: int | None = None,
) -> E2eSupervision:
    S = fst.num_states
    if S == 0:
        raise ValueError("empty e2e supervision FST")
    in_arcs: list[list[tuple[int, int, float]]] = [[] for _ in range(S)]
    for s, a in fst.all_arcs():
        if a.label <= 0:
            raise ValueError("e2e supervision FST must be epsilon-free")
        in_arcs[a.dst].append((s, a.label - 1, a.weight))
    S_max = max_states or S
    K = max_arcs or max((len(x) for x in in_arcs), default=1)
    if S > S_max or max(len(x) for x in in_arcs) > K:
        raise ValueError("supervision exceeds padding budget")
    in_src = np.full((S_max, K), -1, dtype=np.int32)
    in_pdf = np.zeros((S_max, K), dtype=np.int32)
    in_logw = np.full((S_max, K), NEG_INF, dtype=np.float32)
    final_logw = np.full((S_max,), NEG_INF, dtype=np.float32)
    for s in range(S):
        for k, (src, pdf, w) in enumerate(in_arcs[s]):
            if pdf >= num_pdfs:
                raise ValueError("pdf out of range")
            in_src[s, k] = src
            in_pdf[s, k] = pdf
            in_logw[s, k] = w
        if fst.is_final(s):
            final_logw[s] = fst.final(s)
    return E2eSupervision(
        num_frames=num_frames,
        num_pdfs=num_pdfs,
        max_states=S_max,
        max_arcs=K,
        weight=weight,
        in_src=in_src,
        in_pdf=in_pdf,
        in_logw=in_logw,
        final_logw=final_logw,
    )


def pad_and_stack_e2e(sups: list[E2eSupervision]) -> E2eSupervision:
    if not sups:
        raise ValueError("no supervisions")
    T = sups[0].num_frames
    if any(s.num_frames != T for s in sups):
        raise ValueError("all sequences in a batch must share num_frames")
    S = max(s.max_states for s in sups)
    K = max(s.max_arcs for s in sups)
    B = len(sups)
    P = sups[0].num_pdfs
    in_src = np.full((B, S, K), -1, dtype=np.int32)
    in_pdf = np.zeros((B, S, K), dtype=np.int32)
    in_logw = np.full((B, S, K), NEG_INF, dtype=np.float32)
    final_logw = np.full((B, S), NEG_INF, dtype=np.float32)
    for b, s in enumerate(sups):
        in_src[b, : s.max_states, : s.max_arcs] = s.in_src
        in_pdf[b, : s.max_states, : s.max_arcs] = s.in_pdf
        in_logw[b, : s.max_states, : s.max_arcs] = s.in_logw
        final_logw[b, : s.max_states] = s.final_logw
    frame_weights = None
    if any(s.frame_weights is not None for s in sups):
        frame_weights = np.ones((B, T), dtype=np.float32)
        for b, s in enumerate(sups):
            if s.frame_weights is not None:
                frame_weights[b] = s.frame_weights
    return E2eSupervision(
        num_frames=T,
        num_pdfs=P,
        max_states=S,
        max_arcs=K,
        weight=np.array([s.weight for s in sups], dtype=np.float32),
        in_src=in_src,
        in_pdf=in_pdf,
        in_logw=in_logw,
        final_logw=final_logw,
        frame_weights=frame_weights,
    )
