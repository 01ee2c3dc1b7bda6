"""Numerator graphs for the reference: each chunk's tolerance lattice over
pdfs (Kaldi's AlignmentToProtoSupervision with left/right tolerance in
output frames), and its product with the denominator HMM started from the
initial probabilities (the normalization FST's composition, Kaldi's
AddWeightToSupervisionFst), as index arrays frame by frame.

Plain NumPy: a lattice state is (frame, phone index, in self-loop); its arc
at frame t emits the pdf of that phone (class 1 in the self-loop, class 0
on the phone's first frame) and either stays in the phone or moves to the
next one, which may start within the tolerance window of its aligned
start.  Each phone keeps at least one frame; the first phone starts at
frame 0 and the last ends at frame T.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Lattice:
    """One chunk's lattice, frame-synchronous: `states[t]` states at frame t
    (frame 0 holds the start, local index 0); the arcs leaving frame t are
    `arcs[t]` = (src local index, dst local index at t+1, pdf) int64
    arrays; the final states are the local indices `final` at frame T."""

    states: list
    arcs: list
    final: np.ndarray


def chunk_lattice(ali, pdf_of, left_phone: int, tol_left: int, tol_right: int) -> Lattice:
    """`ali`: (phone, frames) pairs at the output rate; `pdf_of(phone,
    pdf_class, left)` the tree."""
    T = sum(d for _, d in ali)
    N = len(ali)
    phones = [p for p, _ in ali]
    starts = np.cumsum([0] + [d for _, d in ali])[:-1]
    lo = [max(0, int(s) - tol_left) for s in starts]
    hi = [min(T - 1, int(s) + tol_right) for s in starts]
    lo[0] = hi[0] = 0
    for i in range(N):
        hi[i] = min(hi[i], T - (N - i))
        lo[i] = max(lo[i], i)
        if lo[i] > hi[i]:
            raise ValueError(f"phone {i} cannot fit its tolerance window")
    left_of = [left_phone] + phones[:-1]
    index = [dict() for _ in range(T + 1)]
    index[0][(0, 0)] = 0
    arcs = [[] for _ in range(T)]
    for t in range(T):
        for (i, loop), s in list(index[t].items()):
            pdf = pdf_of(phones[i], 1 if loop else 0, left_of[i])
            nxt = []
            if t + 1 == T:
                if i == N - 1:
                    nxt.append((i, 2))
            else:
                nxt.append((i, 1))
                if i + 1 < N and lo[i + 1] <= t + 1 <= hi[i + 1]:
                    nxt.append((i + 1, 0))
            for key in nxt:
                d = index[t + 1].setdefault(key, len(index[t + 1]))
                arcs[t].append((s, d, pdf))
    final = np.array([s for (i, loop), s in index[T].items() if loop == 2], dtype=np.int64)
    return Lattice([len(ix) for ix in index],
                   [np.array(a, dtype=np.int64).reshape(-1, 3) for a in arcs], final)


@dataclasses.dataclass
class Product:
    """The lattices of a batch times the denominator HMM, frame by frame.
    Product state (j, s): lattice state j (the batch's lattice states at
    frame t, numbered in row order) and HMM state s; `rows[t]` the batch row
    of each lattice state at frame t.  `pairs[t]` = (j, s, j', s', den arc,
    row, pdf) for every pair of a lattice arc and an HMM arc of the same pdf
    leaving frame t; `final_rows` and `final` the lattice states at frame T
    that end their sequence."""

    num_states: int
    rows: list
    pairs: list
    final: np.ndarray
    final_rows: np.ndarray


def product(lattices: list, den_src, den_dst, den_pdf) -> Product:
    """Pair every lattice arc with each HMM arc of its pdf."""
    den_src, den_dst, den_pdf = (np.asarray(a, dtype=np.int64) for a in (den_src, den_dst,
                                                                      den_pdf))
    order = np.argsort(den_pdf, kind="stable")
    P = int(den_pdf.max()) + 1
    first = np.searchsorted(den_pdf[order], np.arange(P + 1))
    T = len(lattices[0].arcs)
    rows, pairs = [], []
    offsets = np.zeros(len(lattices), dtype=np.int64)
    for t in range(T + 1):
        n = np.array([lat.states[t] for lat in lattices], dtype=np.int64)
        rows.append(np.repeat(np.arange(len(lattices)), n))
        nxt = np.concatenate([[0], np.cumsum(n)[:-1]])
        if t == T:
            final = np.concatenate([offsets[b] + lat.final for b, lat in enumerate(lattices)])
            final_rows = np.concatenate([np.full(len(lat.final), b)
                                         for b, lat in enumerate(lattices)])
            break
        n1 = np.array([lat.states[t + 1] for lat in lattices], dtype=np.int64)
        nxt1 = np.concatenate([[0], np.cumsum(n1)[:-1]])
        a = np.concatenate([lat.arcs[t] for lat in lattices])
        b_of = np.concatenate([np.full(len(lat.arcs[t]), b) for b, lat in enumerate(lattices)])
        j = nxt[b_of] + a[:, 0]
        j1 = nxt1[b_of] + a[:, 1]
        lo, hi = first[a[:, 2]], first[a[:, 2] + 1]
        cnt = hi - lo
        e = np.repeat(np.arange(len(a)), cnt)
        k = order[np.repeat(lo, cnt) + (np.arange(cnt.sum()) - np.repeat(np.cumsum(cnt) - cnt, cnt))]
        pairs.append(np.stack([j[e], den_src[k], j1[e], den_dst[k], k, b_of[e], a[e, 2]]))
        offsets = nxt1
    return Product(len(lattices), rows, pairs, final, final_rows)


def live_sizes(prod: Product, num_den_states: int) -> dict:
    """What the numerator's composed graphs hold once trimmed: product
    states reachable from a start (frame 0, every HMM state: the
    normalization FST's initial arcs) that reach a final one, and the arcs
    between them: the live arcs (frame 0 and later frames apart), states,
    and each (row, frame)'s distinct pdfs, summed over the batch."""
    T = len(prod.pairs)
    S = num_den_states
    fwd = [np.ones(len(prod.rows[0]) * S, bool)]
    for t in range(T):
        j, s, j1, s1 = prod.pairs[t][:4]
        m = np.zeros(len(prod.rows[t + 1]) * S, bool)
        m[(j1 * S + s1)[fwd[t][j * S + s]]] = True
        fwd.append(m)
    bwd = np.zeros(len(prod.rows[T]) * S, bool)
    bwd.reshape(-1, S)[prod.final] = True
    arcs0 = arcs = states = vocab = 0
    for t in range(T - 1, -1, -1):
        j, s, j1, s1, _k, row, pdf = prod.pairs[t]
        live = fwd[t][j * S + s] & bwd[j1 * S + s1]
        if t == 0:
            arcs0 = int(live.sum())
        else:
            arcs += int(live.sum())
        states += int((fwd[t + 1] & bwd).sum())
        prev = np.zeros(len(prod.rows[t]) * S, bool)
        prev[(j * S + s)[live]] = True
        bwd = prev
        vocab += len(np.unique(row[live] * (1 << 32) + pdf[live]))
    return dict(arcs_frame0=arcs0, arcs_steady=arcs, states=states, vocab=vocab, frames=T)
