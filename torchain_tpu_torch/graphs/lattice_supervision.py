"""Lattice-weighted numerator supervision (a copy of
torchain_tpu/graphs/lattice_supervision.py, which imports no JAX).

Behavioral reference: kaldi/src/chain/chain-supervision.cc
`PhoneLatticeToProtoSupervision` — numerator supervision built from a
phone-level LATTICE (e.g. GMM decode alternatives) instead of a 1-best
alignment, so training mass is shared over weighted per-frame phone
alternatives.  Re-designed in the style of
supervision.alignment_to_supervision_fst: instead of a composition chain
(lattice -> proto -> time-enforcer -> pdf projection), the weighted
tolerance lattice is built directly as one acyclic acceptor over
(pdf_id + 1) labels whose states are (frame, lattice-arc, left-phone,
in-self-loop) tuples.

Semantics per lattice path: the path's phones must be realized in order;
phone token a (a lattice arc u -> v) may start within
[time[u] - left_tolerance, time[u] + right_tolerance] (clamped), the
first token starts at frame 0, and the chunk must end at a final lattice
node.  The token's lattice log-weight rides on its first (entry) frame
arc, so the total path weight equals the lattice path weight — which is
exactly what the chain numerator then marginalizes over (verified against
brute-force path enumeration in tests/test_lattice_supervision.py).

A linear lattice with zero weights reproduces
alignment_to_supervision_fst's language and weights exactly.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from torchain_tpu_torch.fstkit import Fst, connect
from torchain_tpu_torch.graphs.supervision import SupervisionOptions
from torchain_tpu_torch.graphs.topology import BOUNDARY, ContextTree


@dataclasses.dataclass
class PhoneLattice:
    """A small acyclic phone lattice with frame-aligned nodes.

    arcs: (src_node, dst_node, phone, log_weight); `times[n]` is node n's
    nominal frame; node 0 is the start (times[0] == 0); `finals` is the
    set of end nodes (nominal time == num_frames)."""

    num_nodes: int
    arcs: list[tuple[int, int, int, float]]
    times: list[int]
    finals: set[int]

    def validate(self) -> None:
        if self.times[0] != 0:
            raise ValueError("lattice must start at frame 0")
        for u, v, p, _w in self.arcs:
            if not (0 <= u < self.num_nodes and 0 <= v < self.num_nodes):
                raise ValueError("arc endpoint out of range")
            if self.times[v] <= self.times[u]:
                raise ValueError("lattice arcs must advance time")
            if p < 1:
                raise ValueError("phones are 1-based")
        if not self.finals:
            raise ValueError("lattice has no final nodes")

    @property
    def num_frames(self) -> int:
        return max(self.times[n] for n in self.finals)

    @staticmethod
    def from_alignment(ali: list[tuple[int, int]]) -> "PhoneLattice":
        """Linear 1-best lattice (alignment parity case)."""
        times = [0]
        arcs = []
        for i, (p, d) in enumerate(ali):
            times.append(times[-1] + d)
            arcs.append((i, i + 1, p, 0.0))
        return PhoneLattice(
            num_nodes=len(ali) + 1,
            arcs=arcs,
            times=times,
            finals={len(ali)},
        )

    @staticmethod
    def from_sausage(
        bins: list[list[tuple[int, float]]],
        durations: list[int],
        normalize: bool = True,
    ) -> "PhoneLattice":
        """Confusion-network ("sausage") lattice: bin i holds weighted
        phone alternatives occupying `durations[i]` output frames."""
        if len(bins) != len(durations):
            raise ValueError("bins and durations must align")
        times = [0]
        for d in durations:
            if d < 1:
                raise ValueError("durations must be >= 1")
            times.append(times[-1] + d)
        arcs = []
        for i, alts in enumerate(bins):
            if not alts:
                raise ValueError(f"bin {i} is empty")
            tot = sum(w for _, w in alts)
            for p, w in alts:
                if w <= 0:
                    raise ValueError("alternative weights must be > 0")
                lw = math.log(w / tot) if normalize else math.log(w)
                arcs.append((i, i + 1, p, lw))
        return PhoneLattice(
            num_nodes=len(bins) + 1,
            arcs=arcs,
            times=times,
            finals={len(bins)},
        )


def lattice_to_supervision_fst(
    lat: PhoneLattice,
    tree: ContextTree,
    opts: SupervisionOptions = SupervisionOptions(),
    num_frames: int | None = None,
    left_context_phone: int = BOUNDARY,
) -> Fst:
    """Weighted tolerance lattice over (pdf_id + 1) labels (see module
    docstring).  Raises if no lattice path fits the frame budget."""
    lat.validate()
    T = num_frames if num_frames is not None else lat.num_frames
    A = len(lat.arcs)
    out_arcs = {n: [] for n in range(lat.num_nodes)}
    for ai, (u, v, p, w) in enumerate(lat.arcs):
        out_arcs[u].append(ai)

    def window(node: int, first: bool) -> tuple[int, int]:
        if first:
            return 0, 0
        t0 = max(1, lat.times[node] - opts.left_tolerance)
        t1 = min(T - 1, lat.times[node] + opts.right_tolerance)
        return t0, t1

    need_left = tree.context_dependent(0) or tree.context_dependent(1)

    fst = Fst()
    state_of: dict[tuple, int] = {}

    def state(key: tuple) -> int:
        if key not in state_of:
            state_of[key] = fst.add_state()
        return state_of[key]

    # single start state = 0; token states keyed (t, arc, left_phone,
    # in_loop) meaning "about to emit frame t of this token"
    assert fst.add_state() == 0
    stack: list[tuple] = []
    seen: set[tuple] = set()

    def visit(key: tuple) -> int:
        if key not in seen:
            seen.add(key)
            stack.append(key)
        return state(key)

    terminal = fst.add_state()
    fst.set_final(terminal, 0.0)

    # frame-0 entries: every start-node token begins at frame 0, its
    # lattice entry weight rides on the start state's arc into it
    for ai in out_arcs[0]:
        fst.add_arc(
            0,
            0,  # label fixed below by emitting from the token state itself
            lat.arcs[ai][3],
            visit((0, ai, left_context_phone, 0)),
        )

    while stack:
        key = stack.pop()
        t, ai, left, in_loop = key
        src = state(key)
        _u, v, phone, _w_entry = lat.arcs[ai]
        pdf_class = 1 if in_loop else 0
        pdf = tree.pdf(phone, pdf_class, left if need_left else BOUNDARY)
        label = pdf + 1
        nt = t + 1
        if nt == T:
            if v in lat.finals:
                fst.add_arc(src, label, 0.0, terminal)
            continue
        # continue this token's self-loop
        fst.add_arc(src, label, 0.0, visit((nt, ai, left, 1)))
        # advance to a successor token starting at frame nt (its lattice
        # weight rides on this transition)
        t0, t1 = window(v, first=False)
        if t0 <= nt <= t1:
            for bi in out_arcs[v]:
                fst.add_arc(
                    src, label, lat.arcs[bi][3], visit((nt, bi, phone, 0))
                )
    # the start state's arcs above carried label 0 (epsilon) — fold them:
    # replace each eps arc 0 -w-> token_state by merging w into the token
    # state's outgoing arcs is wrong in general (states are shared), so
    # instead re-emit: frame-0 token states are reachable ONLY from the
    # start, each via one eps arc; splice by pushing the weight onto the
    # token's frame-0 emission arcs, which that state uniquely owns.
    start_arcs = list(fst.arcs(0))
    fst._arcs[0] = []
    for a in start_arcs:
        for b in fst.arcs(a.dst):
            fst.add_arc(0, b.label, a.weight + b.weight, b.dst)
        if fst.is_final(a.dst):
            raise AssertionError("frame-0 token state cannot be final (T>=1)")

    out = connect(fst)
    if out.num_states == 0 or not any(True for _ in out.arcs(0)):
        raise ValueError("no lattice path fits the frame budget/tolerances")
    return out
