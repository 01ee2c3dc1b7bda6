"""Tied context-dependency trees: data-driven clustering + Kaldi import (a
port of torchain_tpu/graphs/tied_tree.py, which imports no JAX; its
`build_tied_tree` caches the pair losses and gives the same pdf map).

Behavioral reference: Kaldi's tree machinery (kaldi/src/tree/ —
`ContextDependency`, EventMap; build-tree's "accumulate per-context
Gaussian stats, then cluster to a leaf budget").  A real Kaldi recipe's
pdf inventory comes from such a tree; `ContextTree`
(graphs/topology.py) only enumerates untied mono/biphone maps, so this
module supplies the two missing routes to a production pdf map:

  1. `accumulate_tree_stats` + `build_tied_tree` — data-driven: per
     (pdf-class, phone, context) diagonal-Gaussian feature stats from
     alignments, then greedy bottom-up merging of contexts within each
     (pdf-class, phone) group, always taking the globally cheapest
     log-likelihood-loss merge, until the pdf budget is met (the
     agglomerative counterpart of Kaldi's top-down question splitting —
     same objective, same restriction that ties never cross a center
     phone or pdf-class).
  2. `read_kaldi_tree` / `write_kaldi_tree` — parse and emit Kaldi's
     textual ContextDependency format (`CE`/`TE`/`SE` event maps, key -1
     = pdf-class, keys 0..N-1 = context positions), so an existing Kaldi
     system's tree can be imported and its pdf inventory reproduced
     exactly.

`TiedTree` satisfies the same duck-typed interface as `ContextTree`
(num_phones / num_pdfs / context_dependent / pdf), so den graphs,
supervision, HCLG, and the decoders consume it unchanged.  Right context
(triphone, N=3) is carried in the map and exposed via the optional
`right` argument; graph compilers that are left-context-only simply never
pass it (imported N=3 trees then require the triphone-aware expansions).
"""

from __future__ import annotations

import dataclasses
import heapq
import math

import numpy as np

from torchain_tpu_torch.graphs.topology import BOUNDARY


class TiedTree:
    """pdf map [pdf_class, phone, left, right] -> pdf id.

    `phone` is 1-based; contexts use 0 = utterance boundary.  Trees without
    right context have right_size == 1 (index 0 always)."""

    def __init__(self, pdf_map: np.ndarray, num_phones: int):
        if pdf_map.ndim != 4:
            raise ValueError("pdf_map must be [class, phone+1, left, right]")
        self.pdf_map = pdf_map.astype(np.int32)
        self.num_phones = int(num_phones)
        self._num_pdfs = int(pdf_map.max()) + 1

    @property
    def num_pdfs(self) -> int:
        return self._num_pdfs

    @property
    def num_classes(self) -> int:
        return self.pdf_map.shape[0]

    @property
    def right_size(self) -> int:
        return self.pdf_map.shape[3]

    @property
    def context_width(self) -> int:
        return 3 if self.right_size > 1 else 2

    def context_dependent(self, pdf_class: int) -> bool:
        m = self.pdf_map[pdf_class, 1:]
        return bool(
            (m != m[:, :1, :1]).any()
        )  # any variation across left/right within a phone

    def right_dependent(self, pdf_class: int) -> bool:
        m = self.pdf_map[pdf_class, 1:]
        return bool((m != m[:, :, :1]).any())

    def pdf(self, phone: int, pdf_class: int, left: int = BOUNDARY, right: int = BOUNDARY) -> int:
        if not (1 <= phone <= self.num_phones):
            raise ValueError(f"phone {phone} out of range 1..{self.num_phones}")
        r = right if self.right_size > 1 else 0
        return int(self.pdf_map[pdf_class, phone, left, r])

    def to_dict(self) -> dict:
        return dict(pdf_map=self.pdf_map, num_phones=self.num_phones)

    @staticmethod
    def from_dict(d: dict) -> "TiedTree":
        return TiedTree(np.asarray(d["pdf_map"]), int(d["num_phones"]))


# ---------------------------------------------------------------------------
# stats accumulation
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TreeStats:
    """Diagonal-Gaussian sufficient stats per (pdf_class, phone, left,
    right) cell; right dim is 1 when context='left'."""

    count: np.ndarray  # [C, P+1, L, R]
    sum: np.ndarray  # [C, P+1, L, R, D]
    sumsq: np.ndarray  # [C, P+1, L, R, D]
    num_phones: int

    @property
    def feat_dim(self) -> int:
        return self.sum.shape[-1]


def accumulate_tree_stats(
    utts,
    num_phones: int,
    frame_subsampling_factor: int = 1,
    context: str = "left",
    num_classes: int = 2,
) -> TreeStats:
    """Accumulate per-context feature stats from aligned utterances.

    `utts`: iterable with .feats [T_in, D] and .alignment [(phone,
    input-frames)] (data/loader.Utterance).  Alignments are subsampled to
    the output rate; each output frame's feature is the center input frame.
    pdf-class 0 = first output frame of a phone, 1 = the rest (chain
    topology, graphs/topology.py)."""
    from torchain_tpu_torch.graphs.supervision import subsample_alignment

    if context not in ("left", "triphone"):
        raise ValueError("context must be 'left' or 'triphone'")
    sigma = num_phones + 1
    R = sigma if context == "triphone" else 1
    fsf = frame_subsampling_factor
    count = np.zeros((num_classes, sigma, sigma, R), dtype=np.float64)
    fsum = fsumsq = None
    for u in utts:
        ali = subsample_alignment(u.alignment, fsf) if fsf > 1 else u.alignment
        D = u.feats.shape[1]
        if fsum is None:
            fsum = np.zeros((num_classes, sigma, sigma, R, D), dtype=np.float64)
            fsumsq = np.zeros_like(fsum)
        t = 0
        phones = [p for p, _ in ali]
        for i, (q, d) in enumerate(ali):
            left = phones[i - 1] if i > 0 else BOUNDARY
            right = (
                (phones[i + 1] if i + 1 < len(phones) else BOUNDARY)
                if R > 1
                else 0
            )
            for j in range(d):
                ti = min(t * fsf + fsf // 2, u.feats.shape[0] - 1)
                x = u.feats[ti].astype(np.float64)
                c = 0 if j == 0 else min(1, num_classes - 1)
                count[c, q, left, right] += 1.0
                fsum[c, q, left, right] += x
                fsumsq[c, q, left, right] += x * x
                t += 1
    if fsum is None:
        raise ValueError("no utterances")
    return TreeStats(count=count, sum=fsum, sumsq=fsumsq, num_phones=num_phones)


# ---------------------------------------------------------------------------
# greedy agglomerative tying
# ---------------------------------------------------------------------------


_VAR_FLOOR = 1e-4


def _loglike(n, s, ss):
    """ML diagonal-Gaussian log-likelihood of data with stats (n, s, ss)."""
    if n <= 0:
        return 0.0
    mean = s / n
    var = np.maximum(ss / n - mean * mean, _VAR_FLOOR)
    return -0.5 * float(n) * float(
        np.sum(np.log(var)) + var.shape[0] * (math.log(2 * math.pi) + 1.0)
    )


def build_tied_tree(
    stats: TreeStats,
    num_pdfs: int,
    min_count: float = 0.0,
) -> TiedTree:
    """Greedily merge context cells (within each (pdf-class, phone) group)
    until at most `num_pdfs` leaves remain, choosing at each step the merge
    with the smallest total log-likelihood loss anywhere in the tree.

    Every (pdf-class, phone) keeps at least one pdf; contexts never seen in
    the stats share the group's highest-count cluster (the backoff leaf).
    Raises if `num_pdfs` is below the number of (class, phone) groups.

    Each group keeps a matrix of its pairs' merge losses, and a merge
    recomputes only the merged cluster's row and column: a group of n cells
    costs O(n^2) losses in all, where recomputing every pair after every
    merge costs O(n^3).  Each loss comes from `_loglike`, one pair at a time
    in float64, and `np.argmin` over the row-major upper triangle takes the
    first minimum in (i, j) order, as a loop over the pairs with a strict
    `<` does: the pdf map is the one the JAX package's loop gives."""
    C, SP, L, R = stats.count.shape
    P = stats.num_phones
    groups = []  # (c, q) -> list of cells; cell = (left, right)
    for c in range(C):
        for q in range(1, P + 1):
            cells = [
                (l, r)
                for l in range(L)
                for r in range(R)
                if stats.count[c, q, l, r] > 0
            ]
            groups.append(((c, q), cells))
    n_groups = len(groups)
    if num_pdfs < n_groups:
        raise ValueError(
            f"num_pdfs={num_pdfs} below the {n_groups} (pdf-class, phone) "
            "groups; ties never cross phones or pdf-classes"
        )

    # per-group clusters: list of (n, s, ss, member cells), None once merged
    # away; each live cluster's log-likelihood; each group's pair losses
    cluster_of = {}
    loglike_of = {}
    losses_of = {}
    for (c, q), cells in groups:
        cl = []
        for (l, r) in cells:
            cl.append(
                [
                    float(stats.count[c, q, l, r]),
                    stats.sum[c, q, l, r].copy(),
                    stats.sumsq[c, q, l, r].copy(),
                    [(l, r)],
                ]
            )
        if not cl:  # unseen phone: single empty cluster
            cl.append([0.0, np.zeros(stats.feat_dim), np.zeros(stats.feat_dim), []])
        cluster_of[(c, q)] = cl
        loglike_of[(c, q)] = [_loglike(x[0], x[1], x[2]) for x in cl]
        losses_of[(c, q)] = np.full((len(cl), len(cl)), np.inf)

    def pair_loss(key, i, j):
        """The loss of merging clusters i < j of group `key`."""
        cl, ll = cluster_of[key], loglike_of[key]
        a, b = cl[i], cl[j]
        # merge tiny clusters for free: forces min_count coverage
        if a[0] < min_count or b[0] < min_count:
            return 0.0
        return ll[i] + ll[j] - _loglike(a[0] + b[0], a[1] + b[1], a[2] + b[2])

    def best_merge(key):
        m = losses_of[key]
        if m.shape[0] < 2:
            return None
        flat = int(np.argmin(m))
        i, j = divmod(flat, m.shape[0])
        if not np.isfinite(m[i, j]):
            return None  # fewer than two live clusters
        return float(m[i, j]), i, j

    heap = []
    version = {k: 0 for k in cluster_of}
    for k, cl in cluster_of.items():
        m = losses_of[k]
        for i in range(len(cl)):
            for j in range(i + 1, len(cl)):
                m[i, j] = pair_loss(k, i, j)
        bm = best_merge(k)
        if bm is not None:
            heapq.heappush(heap, (bm[0], k, version[k], bm[1], bm[2]))
    total = sum(len(cl) for cl in cluster_of.values())
    while total > num_pdfs and heap:
        loss, k, ver, i, j = heapq.heappop(heap)
        if ver != version[k]:
            continue
        cl, m = cluster_of[k], losses_of[k]
        a, b = cl[i], cl[j]
        cl[i] = [a[0] + b[0], a[1] + b[1], a[2] + b[2], a[3] + b[3]]
        cl[j] = None
        loglike_of[k][i] = _loglike(cl[i][0], cl[i][1], cl[i][2])
        m[j, :] = np.inf
        m[:, j] = np.inf
        for x in range(len(cl)):
            if x != i and cl[x] is not None:
                lo, hi = min(x, i), max(x, i)
                m[lo, hi] = pair_loss(k, lo, hi)
        total -= 1
        version[k] += 1
        bm = best_merge(k)
        if bm is not None:
            heapq.heappush(heap, (bm[0], k, version[k], bm[1], bm[2]))

    pdf_map = np.zeros((C, SP, L, R), dtype=np.int32)
    next_pdf = 0
    for (c, q), _ in groups:
        cl = cluster_of[(c, q)]
        idx = [i for i, x in enumerate(cl) if x is not None]
        # backoff leaf = highest-count cluster; unseen contexts land there
        backoff = max(idx, key=lambda i: cl[i][0])
        pids = {i: next_pdf + k for k, i in enumerate(idx)}
        next_pdf += len(idx)
        pdf_map[c, q, :, :] = pids[backoff]
        for i in idx:
            for (l, r) in cl[i][3]:
                pdf_map[c, q, l, r] = pids[i]
    return TiedTree(pdf_map, stats.num_phones)


# ---------------------------------------------------------------------------
# Kaldi ContextDependency text format
# ---------------------------------------------------------------------------


def _tokenize(text: str) -> list[str]:
    return text.replace("(", " ( ").replace(")", " ) ").replace(
        "[", " [ "
    ).replace("]", " ] ").replace("{", " { ").replace("}", " } ").split()


class _EventMapParser:
    """Recursive-descent parser for Kaldi EventMap text serialization
    (kaldi/src/tree/event-map.cc Write/Read):

        CE <pdf>
        TE <key> <size> ( <map-or-NULL> ... )
        SE <key> [ <yes-values> ] { <yes-map> <no-map> }
    """

    def __init__(self, tokens: list[str]):
        self.toks = tokens
        self.i = 0

    def next(self) -> str:
        if self.i >= len(self.toks):
            raise ValueError("truncated Kaldi tree")
        t = self.toks[self.i]
        self.i += 1
        return t

    def expect(self, tok: str) -> None:
        t = self.next()
        if t != tok:
            raise ValueError(f"Kaldi tree parse: expected {tok!r}, got {t!r}")

    def parse_map(self):
        t = self.next()
        if t == "NULL":
            return None
        if t == "CE":
            return ("CE", int(self.next()))
        if t == "TE":
            key = int(self.next())
            size = int(self.next())
            self.expect("(")
            subs = [self.parse_map() for _ in range(size)]
            self.expect(")")
            return ("TE", key, subs)
        if t == "SE":
            key = int(self.next())
            self.expect("[")
            vals = []
            while True:
                v = self.next()
                if v == "]":
                    break
                vals.append(int(v))
            self.expect("{")
            yes = self.parse_map()
            no = self.parse_map()
            self.expect("}")
            return ("SE", key, frozenset(vals), yes, no)
        raise ValueError(f"Kaldi tree parse: unknown node {t!r}")


def _eval_map(node, event: dict[int, int]):
    """Evaluate an event map for {key: value}; None = no answer."""
    while node is not None:
        kind = node[0]
        if kind == "CE":
            return node[1]
        if kind == "TE":
            _, key, subs = node
            v = event.get(key)
            if v is None or not (0 <= v < len(subs)):
                return None
            node = subs[v]
            continue
        _, key, vals, yes, no = node
        v = event.get(key)
        if v is None:
            return None
        node = yes if v in vals else no
    return None


def read_kaldi_tree(path_or_text: str, num_phones: int | None = None) -> TiedTree:
    """Parse a Kaldi `tree` file (text form, e.g. `copy-tree --binary=false`)
    into a TiedTree.

    Supports N in {1, 2, 3} with P = N - 1 (left-context windows, the chain
    convention) or the standard triphone N=3, P=1.  Contexts outside the
    tree's answer set fall back to the phone's most common answer."""
    try:
        text = open(path_or_text).read()
    except (OSError, ValueError):
        text = path_or_text
    toks = _tokenize(text)
    p = _EventMapParser(toks)
    p.expect("ContextDependency")
    N = int(p.next())
    central = int(p.next())
    p.expect("ToPdf")
    root = p.parse_map()
    p.expect("EndContextDependency")
    if N not in (1, 2, 3):
        raise ValueError(f"unsupported context width N={N}")

    # determine num_phones by probing the map if not given
    if num_phones is None:
        num_phones = 0
        # probe TE table sizes on the center key
        def scan(node):
            nonlocal num_phones
            if node is None:
                return
            if node[0] == "TE":
                if node[1] == central:
                    num_phones = max(num_phones, len(node[2]) - 1)
                for s in node[2]:
                    scan(s)
            elif node[0] == "SE":
                num_phones = max(num_phones, max(node[2], default=0))
                scan(node[3])
                scan(node[4])

        scan(root)
        if num_phones <= 0:
            raise ValueError("could not infer num_phones; pass it explicitly")

    sigma = num_phones + 1
    left_pos = central - 1
    right_pos = central + 1
    has_left = left_pos >= 0
    has_right = right_pos <= N - 1
    L = sigma if has_left else 1
    R = sigma if has_right else 1
    # number of pdf-classes: probe key -1 table size; default 2 (chain)
    num_classes = 2
    if root is not None and root[0] == "TE" and root[1] == -1:
        num_classes = len(root[2])

    pdf_map = np.zeros((num_classes, sigma, L, R), dtype=np.int32)
    for q in range(1, sigma):
        for c in range(num_classes):
            answers = {}
            for l in range(L):
                for r in range(R):
                    ev = {-1: c, central: q}
                    if has_left:
                        ev[left_pos] = l
                    if has_right:
                        ev[right_pos] = r
                    answers[(l, r)] = _eval_map(root, ev)
            seen = [a for a in answers.values() if a is not None]
            fallback = (
                max(set(seen), key=seen.count) if seen else 0
            )
            for (l, r), a in answers.items():
                pdf_map[c, q, l, r] = a if a is not None else fallback
    return TiedTree(pdf_map, num_phones)


def write_kaldi_tree(tree: TiedTree) -> str:
    """Serialize a TiedTree in Kaldi ContextDependency text form (left
    context at position 0, center at 1 when left context exists; adds a
    right position when the tree carries one)."""
    has_right = tree.right_size > 1
    N = 3 if has_right else 2
    central = 1
    sigma = tree.num_phones + 1

    def ce(v):
        return f"CE {v}"

    def per_right(c, q, l):
        if not has_right:
            return ce(tree.pdf_map[c, q, l, 0])
        subs = " ".join(ce(tree.pdf_map[c, q, l, r]) for r in range(sigma))
        return f"TE 2 {sigma} ( {subs} )"

    def per_left(c, q):
        subs = " ".join(per_right(c, q, l) for l in range(sigma))
        return f"TE 0 {sigma} ( {subs} )"

    def per_phone(c):
        subs = ["NULL"] + [per_left(c, q) for q in range(1, sigma)]
        return f"TE {central} {sigma} ( " + " ".join(subs) + " )"

    classes = " ".join(per_phone(c) for c in range(tree.num_classes))
    return (
        f"ContextDependency {N} {central} ToPdf "
        f"TE -1 {tree.num_classes} ( {classes} ) EndContextDependency"
    )
