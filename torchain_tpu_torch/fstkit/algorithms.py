"""FST algorithms: the slice of OpenFst behavior chain training needs.

Behavioral references (semantics, not code): `fst::Compose` and
`fst::Connect` as used by kaldi/src/chain/chain-supervision.cc, and Kaldi's
`SortBreadthFirstSearch` (chain-supervision.cc) which time-sorts
supervision FSTs.  Only what the supervision and denominator compilers of
this package call is kept.
"""

from __future__ import annotations

from collections import deque

from torchain_tpu_torch.fstkit.fst import Fst


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


def compose(a: Fst, b: Fst, *, a_ready: bool = False, b_ready: bool = False) -> Fst:
    """Acceptor intersection: paths accepted by both, weights added.

    Both inputs must be epsilon-free (chain usage composes eps-free
    supervision FSTs with the eps-free normalization FST —
    kaldi/src/chain/chain-supervision.cc `AddWeightToSupervisionFst`).

    a_ready/b_ready declare an input already epsilon-free AND arcsorted,
    skipping the per-call check + sort-copy — the loader composes every
    chunk against the SAME large normalization FST, so sorting it once
    (ChainDataset) instead of per chunk removed the dominant term of
    supervision compilation (BENCH_NOTES round 2 host-pipeline fix).
    """
    if not a_ready:
        if a.has_epsilons():
            raise ValueError("compose requires epsilon-free inputs")
        a = arcsort(a)
    if not b_ready:
        if b.has_epsilons():
            raise ValueError("compose requires epsilon-free inputs")
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
