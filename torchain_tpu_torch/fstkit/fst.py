"""Core FST data structure.

Behavioral reference: the subset of `fst::StdVectorFst` that Kaldi's chain
library exercises (kaldi/src/chain/chain-supervision.cc, chain-den-graph.cc);
re-designed as a tiny pure-Python structure because the rebuild only needs
acceptors and the heavy math lives on-device in packed arrays, not here.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterator

NEG_INF = float("-inf")
EPSILON = 0


@dataclasses.dataclass(frozen=True)
class Arc:
    """A single transition: consumes `label` (0 = epsilon), moves to `dst`.

    `weight` is a log-probability contribution of taking this arc.

    `weight2` is an optional second component tracked THROUGH `weight`
    (always `weight2 <= contribution already inside weight`; algorithms
    rank by `weight` alone).  Lattices use it for Kaldi's LatticeWeight
    (graph_cost, acoustic_cost) split [K lat/kaldi-lattice.h]: there
    `weight = graph + acoustic` and `weight2 = acoustic`, so scoring can
    re-weigh the two parts (lattice-scale / LMWT sweep) without
    re-decoding.  Defaults to 0.0 (single-component behavior) everywhere
    else.
    """

    label: int
    weight: float
    dst: int
    weight2: float = 0.0


class Fst:
    """A weighted finite-state acceptor with log-probability weights.

    States are dense integers; state 0 is the start state.  Finality is a
    log-weight per state (NEG_INF = non-final).
    """

    def __init__(self) -> None:
        self._arcs: list[list[Arc]] = []
        self._final: list[float] = []
        self._final2: list[float] = []

    # -- construction -----------------------------------------------------

    def add_state(self) -> int:
        self._arcs.append([])
        self._final.append(NEG_INF)
        self._final2.append(0.0)
        return len(self._arcs) - 1

    def add_states(self, n: int) -> None:
        for _ in range(n):
            self.add_state()

    def add_arc(
        self, src: int, label: int, weight: float, dst: int, weight2: float = 0.0
    ) -> None:
        if dst >= len(self._arcs) or src >= len(self._arcs):
            raise ValueError(f"arc {src}->{dst} references missing state")
        self._arcs[src].append(Arc(label, float(weight), dst, float(weight2)))

    def set_final(
        self, state: int, weight: float = 0.0, weight2: float = 0.0
    ) -> None:
        self._final[state] = float(weight)
        self._final2[state] = float(weight2)

    # -- accessors --------------------------------------------------------

    @property
    def num_states(self) -> int:
        return len(self._arcs)

    @property
    def num_arcs(self) -> int:
        return sum(len(a) for a in self._arcs)

    def arcs(self, state: int) -> list[Arc]:
        return self._arcs[state]

    def all_arcs(self) -> Iterator[tuple[int, Arc]]:
        for s, arcs in enumerate(self._arcs):
            for a in arcs:
                yield s, a

    def final(self, state: int) -> float:
        return self._final[state]

    def final2(self, state: int) -> float:
        """Second (acoustic) component of the final weight — see Arc.weight2."""
        return self._final2[state]

    def is_final(self, state: int) -> bool:
        return self._final[state] > NEG_INF

    def final_states(self) -> list[int]:
        return [s for s in range(self.num_states) if self.is_final(s)]

    def has_epsilons(self) -> bool:
        return any(a.label == EPSILON for _, a in self.all_arcs())

    def labels(self) -> set[int]:
        return {a.label for _, a in self.all_arcs() if a.label != EPSILON}

    # -- transformation helpers -------------------------------------------

    def copy(self) -> "Fst":
        out = Fst()
        out._arcs = [list(arcs) for arcs in self._arcs]
        out._final = list(self._final)
        out._final2 = list(self._final2)
        return out

    def scale_weights(self, scale: float) -> "Fst":
        out = Fst()
        out.add_states(self.num_states)
        for s, a in self.all_arcs():
            out.add_arc(s, a.label, a.weight * scale, a.dst, a.weight2 * scale)
        for s in range(self.num_states):
            if self.is_final(s):
                out.set_final(s, self.final(s) * scale, self.final2(s) * scale)
        return out

    def remove_weights(self) -> "Fst":
        """Unweighted copy (all log-weights zero), as for Kaldi supervision
        FSTs which are unweighted acceptors (chain-supervision.h)."""
        out = Fst()
        out.add_states(self.num_states)
        for s, a in self.all_arcs():
            out.add_arc(s, a.label, 0.0, a.dst)
        for s in range(self.num_states):
            if self.is_final(s):
                out.set_final(s, 0.0)
        return out

    def relabel_states(self, order: list[int]) -> "Fst":
        """Return a copy with state `order[i]` renamed to `i`.

        `order` must be a permutation of all states with `order[0] == 0`
        (start stays start).
        """
        if len(order) != self.num_states:
            raise ValueError("order must cover all states")
        if order and order[0] != 0:
            raise ValueError("start state must stay state 0")
        new_id = {old: new for new, old in enumerate(order)}
        out = Fst()
        out.add_states(self.num_states)
        for s, a in self.all_arcs():
            out.add_arc(new_id[s], a.label, a.weight, new_id[a.dst], a.weight2)
        for s in range(self.num_states):
            if self.is_final(s):
                out.set_final(new_id[s], self.final(s), self.final2(s))
        return out

    # -- text I/O (diagnostics) -------------------------------------------

    def to_text(self) -> str:
        """OpenFst-like text lines: `src dst label weight` and `state weight`
        for finals.  Weights printed as log-probs (our convention)."""
        lines = []
        for s in range(self.num_states):
            for a in self._arcs[s]:
                lines.append(f"{s} {a.dst} {a.label} {a.weight:.6g}")
            if self.is_final(s):
                lines.append(f"{s} {self._final[s]:.6g}")
        return "\n".join(lines) + "\n"

    @staticmethod
    def from_text(text: str) -> "Fst":
        fst = Fst()

        def ensure(state: int) -> None:
            while fst.num_states <= state:
                fst.add_state()

        pending: list[tuple[int, int, int, float]] = []
        for line in text.strip().splitlines():
            parts = line.split()
            if not parts:
                continue
            if len(parts) >= 4:
                src, dst, label = int(parts[0]), int(parts[1]), int(parts[2])
                weight = float(parts[3]) if len(parts) > 3 else 0.0
                ensure(max(src, dst))
                pending.append((src, dst, label, weight))
            elif len(parts) <= 2:
                state = int(parts[0])
                weight = float(parts[1]) if len(parts) > 1 else 0.0
                ensure(state)
                fst.set_final(state, weight)
        for src, dst, label, weight in pending:
            fst.add_arc(src, label, weight, dst)
        return fst

    def __repr__(self) -> str:
        return f"Fst(states={self.num_states}, arcs={self.num_arcs})"


def log_add(a: float, b: float) -> float:
    """logsumexp of two log-probs (the log-semiring 'plus')."""
    if a == NEG_INF:
        return b
    if b == NEG_INF:
        return a
    hi, lo = (a, b) if a >= b else (b, a)
    return hi + math.log1p(math.exp(lo - hi))
