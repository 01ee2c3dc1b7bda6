"""FST algorithms: the slice of OpenFst behavior chain training needs.

Behavioral references (semantics, not code): `fst::Compose`, `fst::Connect`,
`fst::RmEpsilon`, `fst::TopSort` as used by kaldi/src/chain/
chain-supervision.cc, and Kaldi's `SortBreadthFirstSearch`
(chain-supervision.cc) which time-sorts supervision FSTs.
"""

from __future__ import annotations

from collections import deque
from typing import Iterator

from torchain_tpu_torch.fstkit.fst import EPSILON, NEG_INF, Fst, log_add


def connect(fst: Fst, return_map: bool = False):
    """Trim: keep only states both accessible from the start and coaccessible
    to a final state.  Returns a (possibly empty) new FST; with
    `return_map=True`, returns (fst, keep) where keep[i] is the OLD id of new
    state i (callers use it to carry per-state metadata across the trim)."""
    n = fst.num_states
    if n == 0:
        return (Fst(), []) if return_map else Fst()
    # forward reachability
    fwd = [False] * n
    stack = [0]
    fwd[0] = True
    while stack:
        s = stack.pop()
        for a in fst.arcs(s):
            if not fwd[a.dst]:
                fwd[a.dst] = True
                stack.append(a.dst)
    # backward reachability (build reverse adjacency once)
    radj: list[list[int]] = [[] for _ in range(n)]
    for s, a in fst.all_arcs():
        radj[a.dst].append(s)
    bwd = [False] * n
    stack = [s for s in range(n) if fst.is_final(s)]
    for s in stack:
        bwd[s] = True
    while stack:
        s = stack.pop()
        for p in radj[s]:
            if not bwd[p]:
                bwd[p] = True
                stack.append(p)
    keep = [s for s in range(n) if fwd[s] and bwd[s]]
    if not keep or keep[0] != 0:
        return (Fst(), []) if return_map else Fst()  # start died: empty language
    new_id = {old: i for i, old in enumerate(keep)}
    out = Fst()
    out.add_states(len(keep))
    for s in keep:
        for a in fst.arcs(s):
            if a.dst in new_id:
                out.add_arc(new_id[s], a.label, a.weight, new_id[a.dst], a.weight2)
        if fst.is_final(s):
            out.set_final(new_id[s], fst.final(s), fst.final2(s))
    return (out, keep) if return_map else out


def arcsort(fst: Fst) -> Fst:
    """Sort each state's arcs by (label, dst) — enables the merge join in
    compose()."""
    out = fst.copy()
    for s in range(out.num_states):
        out._arcs[s] = sorted(out._arcs[s], key=lambda a: (a.label, a.dst))
    return out


def rm_epsilon(fst: Fst) -> Fst:
    """Remove epsilon arcs (log semiring).

    Requires the epsilon sub-graph to be acyclic (true for every FST chain
    training builds; asserted).  For each state, the epsilon-closure is
    folded into direct non-epsilon arcs and final weights.
    """
    n = fst.num_states
    # detect epsilon cycles via topo order on eps-subgraph
    order = _topo_order_subgraph(fst, eps_only=True)
    if order is None:
        raise ValueError("epsilon-cycle detected; rm_epsilon requires acyclic eps subgraph")

    # closure[s] = dict dst -> log-weight of all-eps paths s => dst (incl. s itself at 0.0)
    # process states in reverse topological order of the eps subgraph
    closure: list[dict[int, float]] = [dict() for _ in range(n)]
    for s in reversed(order):
        cl: dict[int, float] = {s: 0.0}
        for a in fst.arcs(s):
            if a.label != EPSILON:
                continue
            for t, w in closure[a.dst].items():
                tot = a.weight + w
                cl[t] = log_add(cl.get(t, NEG_INF), tot)
        closure[s] = cl

    out = Fst()
    out.add_states(n)
    for s in range(n):
        new_final = NEG_INF
        arc_acc: dict[tuple[int, int], float] = {}
        for t, wcl in closure[s].items():
            if fst.is_final(t):
                new_final = log_add(new_final, wcl + fst.final(t))
            for a in fst.arcs(t):
                if a.label == EPSILON:
                    continue
                key = (a.label, a.dst)
                arc_acc[key] = log_add(arc_acc.get(key, NEG_INF), wcl + a.weight)
        for (label, dst), w in arc_acc.items():
            out.add_arc(s, label, w, dst)
        if new_final > NEG_INF:
            out.set_final(s, new_final)
    return connect(out)


def _topo_order_subgraph(fst: Fst, eps_only: bool) -> list[int] | None:
    """Kahn topological order over the (eps-)subgraph; None if cyclic.
    All states are included in the order (isolated ones too)."""
    n = fst.num_states
    indeg = [0] * n
    for _, a in fst.all_arcs():
        if (not eps_only) or a.label == EPSILON:
            indeg[a.dst] += 1
    q = deque(s for s in range(n) if indeg[s] == 0)
    order: list[int] = []
    while q:
        s = q.popleft()
        order.append(s)
        for a in fst.arcs(s):
            if (not eps_only) or a.label == EPSILON:
                indeg[a.dst] -= 1
                if indeg[a.dst] == 0:
                    q.append(a.dst)
    return order if len(order) == n else None


def topsort(fst: Fst) -> Fst:
    """Relabel states into a topological order (start first).  Raises on
    cyclic input."""
    order = _topo_order_subgraph(fst, eps_only=False)
    if order is None:
        raise ValueError("topsort: FST is cyclic")
    # start state must come first; it has indeg 0 in a connected acyclic FST,
    # but Kahn may emit other roots first — rotate start to front.
    if 0 in order:
        order.remove(0)
    order.insert(0, 0)
    return fst.relabel_states(order)


def bfs_time_sort(fst: Fst) -> Fst:
    """Breadth-first state sort, Kaldi `SortBreadthFirstSearch`
    (kaldi/src/chain/chain-supervision.cc) semantics: states renumbered in
    BFS discovery order from the start.  For an epsilon-free acceptor whose
    every path consumes exactly one label per transition, this orders states
    by frame index — the property the numerator computation relies on
    (kaldi/src/chain/chain-numerator.cc)."""
    n = fst.num_states
    if n == 0:
        raise ValueError("bfs_time_sort: empty FST")
    seen = [False] * n
    order: list[int] = []
    q = deque([0])
    seen[0] = True
    while q:
        s = q.popleft()
        order.append(s)
        for a in fst.arcs(s):
            if not seen[a.dst]:
                seen[a.dst] = True
                q.append(a.dst)
    if len(order) != n:
        raise ValueError("bfs_time_sort requires a connected FST (run connect first)")
    return fst.relabel_states(order)


def reverse(fst: Fst) -> Fst:
    """Reverse the FST: new super-start (state 0) epsilon-connects to old
    finals; old start becomes final.  Arc labels kept on reversed arcs."""
    n = fst.num_states
    out = Fst()
    out.add_states(n + 1)  # 0 is the new super-start; old state s -> s+1
    for s, a in fst.all_arcs():
        out.add_arc(a.dst + 1, a.label, a.weight, s + 1)
    for s in range(n):
        if fst.is_final(s):
            out.add_arc(0, EPSILON, fst.final(s), s + 1)
    out.set_final(1, 0.0)  # old start (state 0) -> new state 1
    return out


def compose(a: Fst, b: Fst, *, a_ready: bool = False, b_ready: bool = False) -> Fst:
    """Acceptor intersection: paths accepted by both, weights added.

    Both inputs must be epsilon-free (chain usage composes eps-free
    supervision FSTs with the eps-free normalization FST —
    kaldi/src/chain/chain-supervision.cc `AddWeightToSupervisionFst`).
    Call rm_epsilon() first otherwise.

    a_ready/b_ready declare an input already epsilon-free AND arcsorted,
    skipping the per-call check + sort-copy — the loader composes every
    chunk against the SAME large normalization FST, so sorting it once
    (ChainDataset) instead of per chunk removed the dominant term of
    supervision compilation.
    """
    if not a_ready:
        if a.has_epsilons():
            raise ValueError("compose requires epsilon-free inputs; run rm_epsilon first")
        a = arcsort(a)
    if not b_ready:
        if b.has_epsilons():
            raise ValueError("compose requires epsilon-free inputs; run rm_epsilon first")
        b = arcsort(b)
    state_id: dict[tuple[int, int], int] = {}
    out = Fst()

    def get_state(sa: int, sb: int) -> int:
        key = (sa, sb)
        if key not in state_id:
            state_id[key] = out.add_state()
        return state_id[key]

    start = get_state(0, 0)
    assert start == 0
    stack = [(0, 0)]
    visited = {(0, 0)}
    while stack:
        sa, sb = stack.pop()
        s_out = get_state(sa, sb)
        if a.is_final(sa) and b.is_final(sb):
            out.set_final(s_out, a.final(sa) + b.final(sb))
        # merge-join sorted arc lists on label
        arcs_a, arcs_b = a.arcs(sa), b.arcs(sb)
        i = j = 0
        while i < len(arcs_a) and j < len(arcs_b):
            la, lb = arcs_a[i].label, arcs_b[j].label
            if la < lb:
                i += 1
            elif lb < la:
                j += 1
            else:
                # all pairs sharing this label
                i2 = i
                while i2 < len(arcs_a) and arcs_a[i2].label == la:
                    i2 += 1
                j2 = j
                while j2 < len(arcs_b) and arcs_b[j2].label == la:
                    j2 += 1
                for aa in arcs_a[i:i2]:
                    for ab in arcs_b[j:j2]:
                        key = (aa.dst, ab.dst)
                        dst = get_state(*key)
                        out.add_arc(s_out, la, aa.weight + ab.weight, dst)
                        if key not in visited:
                            visited.add(key)
                            stack.append(key)
                i, j = i2, j2
    return connect(out)


def merge_bisimilar(fst: Fst, weight_decimals: int = 6) -> Fst:
    """Merge forward-bisimilar states: states with identical
    (final weight, multiset of (label, weight, dst-class)) signatures are
    collapsed, by partition refinement to a fixed point.

    Sound in the log (sum) semiring: in-arcs are preserved individually, so
    merged states accumulate the same forward mass and emit identical
    futures — total path weights are unchanged.  This is the minimization
    role Kaldi's den-graph pipeline gets from fst::Minimize
    (chain-den-graph.cc), adapted to nondeterministic acceptors."""
    n = fst.num_states
    if n == 0:
        return fst.copy()
    # initial partition: by final weight
    cls = {}
    key_of = [None] * n
    for s in range(n):
        k = round(fst.final(s), weight_decimals) if fst.is_final(s) else None
        key_of[s] = k
    keys = {k: i for i, k in enumerate(sorted(set(key_of), key=repr))}
    part = [keys[key_of[s]] for s in range(n)]
    while True:
        sigs: dict[tuple, int] = {}
        new_part = [0] * n
        for s in range(n):
            sig = (
                part[s],
                tuple(
                    sorted(
                        (a.label, round(a.weight, weight_decimals), part[a.dst])
                        for a in fst.arcs(s)
                    )
                ),
            )
            if sig not in sigs:
                sigs[sig] = len(sigs)
            new_part[s] = sigs[sig]
        if new_part == part:
            break
        part = new_part
    num_classes = max(part) + 1
    if num_classes == n:
        return fst.copy()
    # representative state per class; class of start must become state 0
    out = Fst()
    class_id = {}

    def cid(c: int) -> int:
        if c not in class_id:
            class_id[c] = out.add_state()
        return class_id[c]

    assert cid(part[0]) == 0
    emitted = set()
    for s in range(n):
        c = part[s]
        if c in emitted:
            continue
        emitted.add(c)
        src = cid(c)
        for a in fst.arcs(s):
            out.add_arc(src, a.label, a.weight, cid(part[a.dst]))
        if fst.is_final(s):
            out.set_final(src, fst.final(s))
    return out


def shortest_distance(
    fst: Fst, reverse_dir: bool = False, semiring: str = "log"
) -> list[float]:
    """Log (or tropical) forward/backward state distances on an ACYCLIC fst.

    forward:  d[s] = weight of all paths start => s
    backward: d[s] = weight of all paths s => final (incl. final weight)
    """
    order = _topo_order_subgraph(fst, eps_only=False)
    if order is None:
        raise ValueError("shortest_distance implemented for acyclic FSTs only")
    plus = max if semiring == "tropical" else log_add
    n = fst.num_states
    d = [NEG_INF] * n
    if not reverse_dir:
        d[0] = 0.0
        for s in order:
            if d[s] == NEG_INF:
                continue
            for a in fst.arcs(s):
                d[a.dst] = plus(d[a.dst], d[s] + a.weight)
    else:
        for s in range(n):
            if fst.is_final(s):
                d[s] = fst.final(s)
        for s in reversed(order):
            for a in fst.arcs(s):
                if d[a.dst] > NEG_INF:
                    d[s] = plus(d[s], a.weight + d[a.dst])
    return d


def total_weight(fst: Fst, semiring: str = "log") -> float:
    """Total log-weight of all accepting paths (acyclic only)."""
    d = shortest_distance(fst, reverse_dir=True, semiring=semiring)
    return d[0] if fst.num_states else NEG_INF


def enumerate_paths(
    fst: Fst, max_paths: int = 1_000_000
) -> Iterator[tuple[tuple[int, ...], float]]:
    """Yield (label_sequence, path_log_weight) for every accepting path of an
    acyclic FST.  Test oracle for brute-force verification of fwd-bwd math."""
    count = 0
    stack: list[tuple[int, tuple[int, ...], float]] = [(0, (), 0.0)]
    while stack:
        s, labels, w = stack.pop()
        if fst.is_final(s):
            yield labels, w + fst.final(s)
            count += 1
            if count >= max_paths:
                raise RuntimeError("enumerate_paths: too many paths")
        for a in fst.arcs(s):
            new_labels = labels if a.label == EPSILON else labels + (a.label,)
            stack.append((a.dst, new_labels, w + a.weight))
