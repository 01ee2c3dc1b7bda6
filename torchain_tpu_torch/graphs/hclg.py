"""Word-level decoding-graph (HCLG) compiler (a copy of
torchain_tpu/graphs/hclg.py, which imports no JAX).

Behavioral reference: the graph that Kaldi's latgen-faster-mapped decodes —
HCLG = H (chain topology) o C (context) o L (lexicon) o G (word grammar),
built upstream by utils/mkgraph.sh with determinization and minimization
(SURVEY.md section 3.4).  Re-designed here as a DIRECT compiler instead of
generic FST composition: because the chain topology and tree flavors are
fixed (graphs/topology.py), the composed machine can be enumerated
epsilon-free in one pass, the same construction style as
den_graph.expand_lm_to_hmm:

  * word labels and grammar weights ride the FIRST phone's entry arcs
    (early emission — what Kaldi's determinization achieves by pushing),
    so the graph needs no epsilon arcs and every arc consumes a frame;
  * pronunciation-suffix sharing: word-internal states are keyed on
    (grammar dst state, pronunciation, position), so identical word
    continuations share states across grammar sources;
  * optional inter-word silence (sil_phone/sil_prob) enters as a
    label-less pseudo-word looping back to the same grammar state.

The output packs into eval.decoder.DecodingGraph (same arc tensors the
numpy/C++ Viterbi and the lattice generator consume) with word ids as
output labels, so the whole eval stack — best path, lattices, N-best,
WER — works at the word level unchanged.
"""

from __future__ import annotations

import dataclasses
import math

from torchain_tpu_torch.fstkit import Fst
from torchain_tpu_torch.graphs.topology import BOUNDARY, ChainTopology, ContextTree


@dataclasses.dataclass
class Lexicon:
    """word id (>= 1) -> list of pronunciations (tuples of 1-based phones)."""

    prons: dict[int, list[tuple[int, ...]]]
    #: optional inter-word silence: 0 disables
    sil_phone: int = 0
    sil_prob: float = 0.5

    def validate(self, num_phones: int) -> None:
        if not self.prons:
            raise ValueError("empty lexicon")
        for w, ps in self.prons.items():
            if w < 1:
                raise ValueError("word ids must be >= 1")
            if not ps:
                raise ValueError(f"word {w} has no pronunciation")
            for p in ps:
                if len(p) == 0:
                    raise ValueError(f"word {w} has an empty pronunciation")
                if any(not (1 <= q <= num_phones) for q in p):
                    raise ValueError(f"word {w} pronunciation out of range")
        if self.sil_phone and not (1 <= self.sil_phone <= num_phones):
            raise ValueError("sil_phone out of range")


def make_hclg(
    word_lm: Fst,
    lexicon: Lexicon,
    tree: ContextTree,
    topo: ChainTopology = ChainTopology(),
    lm_scale: float = 1.0,
) -> tuple[Fst, list[int]]:
    """Compile grammar + lexicon + tree + chain topology into an epsilon-free
    HMM acceptor over (pdf_id + 1) labels, returning per-arc WORD output
    labels (word id on the entry arc of each word's first phone, 0
    elsewhere) aligned with `fst.all_arcs()` order.

    `word_lm` is an acceptor over word ids (graphs.estimate_phone_lm output
    trained on word sequences serves directly); its weights and final
    weights are scaled by `lm_scale`.
    """
    if word_lm.has_epsilons():
        raise ValueError("word grammar must be epsilon-free")
    rd = getattr(tree, "right_dependent", None)
    if rd is not None and (rd(0) or rd(1)):
        lexicon.validate(tree.num_phones)
        return _make_hclg_triphone(word_lm, lexicon, tree, topo, lm_scale)
    lexicon.validate(tree.num_phones)
    need_prev = tree.context_dependent(0) or tree.context_dependent(1)
    need_loop_ctx = tree.context_dependent(1)
    use_sil = lexicon.sil_phone > 0
    log_sil = math.log(lexicon.sil_prob) if use_sil else 0.0
    log_nosil = math.log(1.0 - lexicon.sil_prob) if use_sil else 0.0

    out = Fst()
    olabel_per_state: dict[int, list[int]] = {}
    state_of: dict[tuple, int] = {}
    stack: list[tuple] = []
    seen: set[tuple] = set()

    def state(key: tuple) -> int:
        if key not in state_of:
            state_of[key] = out.add_state()
        return state_of[key]

    def visit(key: tuple) -> int:
        if key not in seen:
            seen.add(key)
            stack.append(key)
        return state(key)

    def add_arc(src: int, label: int, weight: float, dst: int, word: int):
        out.add_arc(src, label, weight, dst)
        olabel_per_state.setdefault(src, []).append(word)

    def phone_steps(
        src: int, q: int, prev: int, after_key: tuple, entry_w: float, word: int
    ):
        """Emit the chain-topology expansion of one phone q with left
        context `prev`: entry arcs from `src` (carrying entry_w + word
        label), a self-loop state, both exiting to `after_key`."""
        pdf0 = tree.pdf(q, 0, prev)
        loop_key = ("loop", after_key, q, prev if need_loop_ctx else BOUNDARY)
        dst_after = visit(after_key)
        dst_loop = visit(loop_key)
        add_arc(src, pdf0 + 1, entry_w + topo.log_continue, dst_loop, word)
        add_arc(src, pdf0 + 1, entry_w + topo.log_end, dst_after, word)

    # state kinds:
    #   ("bnd", g, prev)        word boundary at grammar state g
    #   ("bnd_ns", g, prev)     same but silence just taken (no second sil)
    #   ("chain", g2, pron, i)  word-internal, pronunciation position i
    #   ("loop", after, q, ctx) mid-phone self-loop exiting to `after`
    start = ("bnd", 0, BOUNDARY)
    assert state(start) == 0
    stack.append(start)
    seen.add(start)

    while stack:
        key = stack.pop()
        kind = key[0]
        src = state(key)
        if kind == "loop":
            _, after_key, q, left = key
            pdf1 = tree.pdf(q, 1, left)
            dst_after = visit(after_key)
            add_arc(src, pdf1 + 1, topo.log_continue, src, 0)
            add_arc(src, pdf1 + 1, topo.log_end, dst_after, 0)
        elif kind == "chain":
            _, g2, pron, pos = key
            q = pron[pos]
            prev = pron[pos - 1] if need_prev else BOUNDARY
            if pos + 1 == len(pron):
                after = ("bnd", g2, q if need_prev else BOUNDARY)
            else:
                after = ("chain", g2, pron, pos + 1)
            phone_steps(src, q, prev, after, 0.0, 0)
        else:  # "bnd" / "bnd_ns"
            _, g, prev = key
            if word_lm.is_final(g):
                out.set_final(src, word_lm.final(g) * lm_scale)
            word_w0 = 0.0
            if kind == "bnd" and use_sil:
                # optional silence pseudo-word looping to the same grammar
                # state; the no-silence branch pays log(1 - sil_prob)
                sil_after = ("bnd_ns", g, lexicon.sil_phone if need_prev else BOUNDARY)
                phone_steps(src, lexicon.sil_phone, prev, sil_after, log_sil, 0)
                word_w0 = log_nosil
            for a in word_lm.arcs(g):
                w, g2 = a.label, a.dst
                lmw = a.weight * lm_scale + word_w0
                for pron in lexicon.prons[w]:
                    q0 = pron[0]
                    if len(pron) == 1:
                        after = ("bnd", g2, q0 if need_prev else BOUNDARY)
                    else:
                        after = ("chain", g2, pron, 1)
                    phone_steps(src, q0, prev, after, lmw, w)

    arc_olabel = [
        ol for s in range(out.num_states) for ol in olabel_per_state.get(s, [])
    ]
    assert len(arc_olabel) == out.num_arcs
    return out, arc_olabel


def _make_hclg_triphone(
    word_lm: Fst,
    lexicon: Lexicon,
    tree,
    topo: ChainTopology,
    lm_scale: float,
) -> tuple[Fst, list[int]]:
    """Right-context (triphone) word HCLG with CROSS-WORD context.

    Triphone pdfs depend on (left, phone, right), so a phone's frames can
    only be emitted once its successor phone is known — including across
    word boundaries (the role of Kaldi's context FST C with cross-word
    expansion in mkgraph).  Same delayed-emission device as
    den_graph._expand_lm_to_hmm_triphone, lifted from a phone LM to the
    phone stream induced by grammar∘lexicon:

      continuation keys (where the stream goes after the pending phone):
        ("bnd", g)              word boundary at grammar state g
        ("bnd_ns", g)           ditto, silence just taken (no second sil)
        ("chain", g2, pron, i)  inside a pronunciation, position i next
      graph states:
        ("pend", cont, q, prev, word)  committed to phone q (left context
            `prev`, word label `word` if q starts a word), frames not yet
            emitted; expansion picks q's successor from `cont`, fixing
            q's pdfs.  Successor-choice weights (grammar/silence) ride
            q's entry arcs, as does q's word label.
        ("loop", cont2, q2, q, prev, word2)  q's self-loop, successor
            already chosen; exits into ("pend", cont2, q2, q, word2).
        ("floop", q, prev) / ("final",)  utterance-final variants
            (right context = BOUNDARY).
    """
    use_sil = lexicon.sil_phone > 0
    log_sil = math.log(lexicon.sil_prob) if use_sil else 0.0
    log_nosil = math.log(1.0 - lexicon.sil_prob) if use_sil else 0.0

    out = Fst()
    olabel_per_state: dict[int, list[int]] = {}
    state_of: dict[tuple, int] = {}
    stack: list[tuple] = []
    seen: set[tuple] = set()

    def state(key: tuple) -> int:
        if key not in state_of:
            state_of[key] = out.add_state()
        return state_of[key]

    def visit(key: tuple) -> int:
        if key not in seen:
            seen.add(key)
            stack.append(key)
        return state(key)

    def add_arc(src: int, label: int, weight: float, dst: int, word: int):
        out.add_arc(src, label, weight, dst)
        olabel_per_state.setdefault(src, []).append(word)

    def successors(cont: tuple):
        """Enumerate the next-phone choices of a continuation key.

        Returns (choices, final_weight): choices are (q2, weight, word2,
        cont2); final_weight is the (scaled) grammar final weight if the
        utterance may end here, else None."""
        kind = cont[0]
        if kind == "chain":
            _, g2, pron, pos = cont
            q2 = pron[pos]
            if pos + 1 == len(pron):
                nxt = ("bnd", g2)
            else:
                nxt = ("chain", g2, pron, pos + 1)
            return [(q2, 0.0, 0, nxt)], None
        _, g = cont
        choices = []
        word_w0 = 0.0
        if kind == "bnd" and use_sil:
            choices.append((lexicon.sil_phone, log_sil, 0, ("bnd_ns", g)))
            word_w0 = log_nosil
        for a in word_lm.arcs(g):
            w, g2 = a.label, a.dst
            lmw = a.weight * lm_scale + word_w0
            for pron in lexicon.prons[w]:
                if len(pron) == 1:
                    nxt = ("bnd", g2)
                else:
                    nxt = ("chain", g2, pron, 1)
                choices.append((pron[0], lmw, w, nxt))
        final_w = word_lm.final(g) * lm_scale if word_lm.is_final(g) else None
        return choices, final_w

    def expand_pend(src: int, cont: tuple, q: int, prev: int, word_q: int, extra_w: float):
        choices, final_w = successors(cont)
        for q2, w2, word2, cont2 in choices:
            pdf0 = tree.pdf(q, 0, prev, q2)
            loop = visit(("loop", cont2, q2, q, prev, word2))
            nxt = visit(("pend", cont2, q2, q, word2))
            add_arc(src, pdf0 + 1, extra_w + w2 + topo.log_continue, loop, word_q)
            add_arc(src, pdf0 + 1, extra_w + w2 + topo.log_end, nxt, word_q)
        if final_w is not None:
            pdf0 = tree.pdf(q, 0, prev, BOUNDARY)
            loop = visit(("floop", q, prev))
            fin = visit(("final",))
            add_arc(src, pdf0 + 1, extra_w + final_w + topo.log_continue, loop, word_q)
            add_arc(src, pdf0 + 1, extra_w + final_w + topo.log_end, fin, word_q)

    # start state 0: the first-phone choice is folded in (no epsilon moves)
    assert state(("start",)) == 0
    seen.add(("start",))
    first_choices, first_final = successors(("bnd", 0))
    for q, w, word, cont2 in first_choices:
        expand_pend(0, cont2, q, BOUNDARY, word, w)
    if first_final is not None:  # zero-word utterance (unreachable for T>=1)
        out.set_final(0, first_final)

    while stack:
        key = stack.pop()
        kind = key[0]
        src = state(key)
        if kind == "pend":
            _, cont, q, prev, word = key
            expand_pend(src, cont, q, prev, word, 0.0)
        elif kind == "loop":
            _, cont2, q2, q, prev, word2 = key
            pdf1 = tree.pdf(q, 1, prev, q2)
            nxt = visit(("pend", cont2, q2, q, word2))
            add_arc(src, pdf1 + 1, topo.log_continue, src, 0)
            add_arc(src, pdf1 + 1, topo.log_end, nxt, 0)
        elif kind == "floop":
            _, q, prev = key
            pdf1 = tree.pdf(q, 1, prev, BOUNDARY)
            fin = visit(("final",))
            add_arc(src, pdf1 + 1, topo.log_continue, src, 0)
            add_arc(src, pdf1 + 1, topo.log_end, fin, 0)
        else:  # ("final",)
            out.set_final(src, 0.0)

    arc_olabel = [
        ol for s in range(out.num_states) for ol in olabel_per_state.get(s, [])
    ]
    assert len(arc_olabel) == out.num_arcs
    return out, arc_olabel
