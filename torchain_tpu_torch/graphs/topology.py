"""HMM topology and context-dependency tree for chain models.

Behavioral reference: Kaldi's "chain" 1-state-per-phone topology (generated
by steps/nnet3/chain/gen_topo.py upstream) and the pdf mapping normally held
by a Kaldi decision tree (kaldi/src/tree/).  The rebuild supports the tree
flavors chain recipes actually use — monophone and left-biphone (the
flat-start / e2e default, optionally with self-loop pdfs tied across left
contexts) — with each phone contributing two pdf classes:

  pdf-class 0  "forward" pdf — emitted on the first frame of the phone
  pdf-class 1  "self-loop" pdf — emitted on every subsequent frame

Chain topology transition structure per phone (probabilities 0.5 each, as in
the reference topology):

    entry --pdf0--> self_loop      (phone continues past 1 frame)
    entry --pdf0--> exit           (phone lasted exactly 1 frame)
    self_loop --pdf1--> self_loop  (phone continues)
    self_loop --pdf1--> exit       (phone ends)

Emissions ride on transitions and are determined by the source topo state's
pdf class — matching Kaldi HMM semantics, which is what makes the expansion
in den_graph.py epsilon-free.
"""

from __future__ import annotations

import dataclasses
import math

LOG_HALF = math.log(0.5)

#: left-context symbol meaning "utterance boundary / unknown"
BOUNDARY = 0


@dataclasses.dataclass(frozen=True)
class ChainTopology:
    """The fixed 1-state chain topology.

    Durations are >= 1 output frame per phone; transition probs are 0.5.
    """

    #: log-prob of continuing (entry->loop, loop->loop)
    log_continue: float = LOG_HALF
    #: log-prob of ending the phone (entry->exit, loop->exit)
    log_end: float = LOG_HALF

    num_pdf_classes: int = 2  # forward (0) and self-loop (1)


class ContextTree:
    """Maps (phone, pdf_class, left_context_phone) -> pdf id.

    Flavors:
      * context_width=1: monophone — pdf depends on (phone, pdf_class).
      * context_width=2, tie_self_loops=True (default): forward pdfs are
        full left-biphone, self-loop pdfs depend on the phone only.  This is
        the usual flat-start compromise keeping num_pdfs = P*(P+2).
      * context_width=2, tie_self_loops=False: full biphone for both
        classes; num_pdfs = 2*P*(P+1).

    Phones are 1-based; left context 0 means utterance boundary.
    """

    def __init__(
        self,
        num_phones: int,
        context_width: int = 1,
        tie_self_loops: bool = True,
    ):
        if context_width not in (1, 2):
            raise ValueError("context_width must be 1 (mono) or 2 (left-biphone)")
        self.num_phones = num_phones
        self.context_width = context_width
        self.tie_self_loops = tie_self_loops if context_width == 2 else True
        p = num_phones
        if context_width == 1:
            self._num_pdfs = 2 * p
        elif self.tie_self_loops:
            self._num_pdfs = p + p * (p + 1)  # self-loops first, then fwd
        else:
            self._num_pdfs = 2 * p * (p + 1)

    @property
    def num_pdfs(self) -> int:
        return self._num_pdfs

    def context_dependent(self, pdf_class: int) -> bool:
        """Does this pdf class's identity depend on the left context?"""
        if self.context_width == 1:
            return False
        return pdf_class == 0 or not self.tie_self_loops

    def right_dependent(self, pdf_class: int) -> bool:
        """ContextTree flavors never use right context (triphone pdf maps
        come from TiedTree — graphs/tied_tree.py)."""
        return False

    def pdf(
        self, phone: int, pdf_class: int, left: int = BOUNDARY, right: int = BOUNDARY
    ) -> int:
        """pdf id in [0, num_pdfs) for 1-based `phone` with the given pdf
        class and left-context phone (0 = boundary); `right` is accepted
        for interface parity with TiedTree and ignored here."""
        if not (1 <= phone <= self.num_phones):
            raise ValueError(f"phone {phone} out of range 1..{self.num_phones}")
        if pdf_class not in (0, 1):
            raise ValueError("pdf_class must be 0 or 1")
        p = self.num_phones
        if self.context_width == 1:
            return 2 * (phone - 1) + pdf_class
        if not (0 <= left <= p):
            raise ValueError(f"left context {left} out of range 0..{p}")
        if self.tie_self_loops:
            if pdf_class == 1:
                return phone - 1
            return p + (phone - 1) * (p + 1) + left
        return 2 * ((phone - 1) * (p + 1) + left) + pdf_class
