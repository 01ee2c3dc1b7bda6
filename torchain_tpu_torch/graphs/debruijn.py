"""De Bruijn lift of the denominator graph: a gather-free dense form.

Behavioral reference: kaldi/src/chain/chain-den-graph.{h,cc} +
chain-kernels.cu (the denominator HMM and its per-arc gather/scatter hot
loop).  Port of torchain_tpu/graphs/debruijn.py (host NumPy, the same
tables): the per-arc loop is replaced by a DENSE reformulation with zero
gathers.

The idea: an n-gram phone LM whose state set is FACTOR-CLOSED (see
phone_lm.PhoneLmOptions.estimator="truncation") is an exact quotient of the
de Bruijn graph over phone contexts of length m = order-1: the automaton
state after any history equals the longest kept suffix of the last m phones,
so lifting alpha/beta from LM states to full contexts commutes with the
transition dynamics.  On the lift, "follow an arc labelled q" is just
"drop the oldest context symbol and append q" — an index SHIFT — so the
whole forward-backward becomes, per frame:

    arr[b, j, q] = sum_r alpha[b, r*D + j] * W[r, j, q]      (tiny einsum)
    alpha'[b, j*Sigma + q] = pdf_probs * arr[b, j, q]        (pure reshape)

with W[c, q] = P_lm(q | cls(c)) a loop-invariant dense table.  No gathers,
no scatters, no segment ops: reshapes and small batched contractions.  The
chain HMM topology (1 state per phone, forward pdf + self-loop pdf:
graphs/topology.py) rides on top as two mass registers per context:

    bnd(c): between phones     loop(c): mid-phone (self-loop)
    arr = shift-einsum(bnd);   u = p0(c')*arr + p1(c')*loop
    bnd' = e_end * u;          loop' = e_cont * u

Emission pdfs depend only on the last two context symbols (left-biphone
trees), so the per-frame pdf probabilities are one [B,P] x [P,Sigma^2]
one-hot matmul, broadcast over the older symbols by reshape.  A tree whose
pdfs depend on the RIGHT context (a triphone `TiedTree`) cannot be lifted
this way: `make_debruijn_den_graph` refuses it (the JAX compiler reads
`tree.pdf(q, cls, prev)` alone and would lift it to another graph).

This module is the host-side compiler producing the packed numpy tables;
ops/den_debruijn.py holds the device recursion.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from torchain_tpu_torch.fstkit import Fst
from torchain_tpu_torch.graphs.phone_lm import BOS
from torchain_tpu_torch.graphs.topology import ChainTopology, ContextTree


@dataclasses.dataclass
class DeBruijnDenGraph:
    """Packed de Bruijn denominator tables (host numpy).

    Context encoding: a context is the last `m` symbols over the alphabet
    {0 = utterance boundary, 1..num_phones}; index
    c = sum_i digit_i * sigma^(m-1-i) with digit_0 the OLDEST symbol, so
    "append q" is c' = (c % sigma^(m-1)) * sigma + q.
    """

    num_phones: int
    num_pdfs: int
    m: int  # context length
    sigma: int  # num_phones + 1
    tail_len: int  # how many trailing symbols determine the pdf (1 or 2)
    log_continue: float
    log_end: float
    #: transition probs W3[r, j, q] = P_lm(q | cls(r*D + j)), prob space,
    #: zero for q=0 / invalid contexts / phones impossible after the context
    W3: np.ndarray  # float32 [sigma, D, sigma], D = sigma^(m-1)
    #: pdf ids per trailing-symbol group g = c % sigma^tail_len
    pdf0_group: np.ndarray  # int32 [G] forward pdfs (0 where q=0: dead)
    pdf1_group: np.ndarray  # int32 [G] self-loop pdfs
    #: initial mass per context and register (stationary + start boost)
    init_bnd: np.ndarray  # float32 [C]
    init_loop: np.ndarray  # float32 [C]
    #: which contexts are representable histories (leading zeros only)
    valid: np.ndarray  # bool [C]
    #: cls[c] = LM state id of the longest kept suffix (-1 = none); kept for
    #: diagnostics and tests
    cls: np.ndarray  # int32 [C]

    @property
    def num_contexts(self) -> int:
        return self.sigma**self.m

    @property
    def num_groups(self) -> int:
        return self.sigma**self.tail_len

    def affine_pdf_specs(self):
        """Detect affine structure pdf_group[prev*sigma + q] == base + qs*q
        + ps*prev (all ContextTree flavors have it).  Returns (spec0, spec1)
        where each is (base, qs, ps) or None.  The device kernel turns an
        affine spec into a strided slice + reshape (+transpose) of y instead
        of a [P, G] one-hot matmul."""
        return (
            _detect_affine(self.pdf0_group, self.sigma, self.tail_len),
            _detect_affine(self.pdf1_group, self.sigma, self.tail_len),
        )


def _detect_affine(group: np.ndarray, sigma: int, tail_len: int):
    p = sigma - 1
    if tail_len == 1:
        qs0 = int(group[2]) - int(group[1]) if p >= 2 else 0
        base = int(group[1]) - qs0
        q = np.arange(1, p + 1)
        if np.array_equal(group[1:], base + qs0 * q):
            return (base, qs0, 0)
        return None
    g2 = group.reshape(sigma, sigma)  # [prev, q]
    if p >= 2:
        qs0 = int(g2[0, 2]) - int(g2[0, 1])
    else:
        qs0 = 0
    ps0 = int(g2[1, 1]) - int(g2[0, 1])
    base = int(g2[0, 1]) - qs0
    prev = np.arange(sigma)[:, None]
    q = np.arange(1, p + 1)[None, :]
    if np.array_equal(g2[:, 1:], base + qs0 * q + ps0 * prev):
        return (base, qs0, ps0)
    return None


def _context_digits(sigma: int, m: int) -> np.ndarray:
    """[C, m] digits of every context, oldest first."""
    c = np.arange(sigma**m, dtype=np.int64)
    digits = np.empty((sigma**m, m), dtype=np.int64)
    for i in range(m):
        digits[:, i] = (c // sigma ** (m - 1 - i)) % sigma
    return digits


def lifts_right_context(tree) -> bool:
    """Whether either pdf class of `tree` depends on the right context, which
    the lift cannot represent (`TiedTree` with context "triphone")."""
    right = getattr(tree, "right_dependent", None)
    return right is not None and (right(0) or right(1))


def make_debruijn_den_graph(
    phone_lm: Fst,
    tree: ContextTree,
    topo: ChainTopology = ChainTopology(),
    start_boost: float = 0.01,
    num_iters: int = 100,
) -> DeBruijnDenGraph:
    """Compile the phone LM + tree + chain topology into de Bruijn tables.

    Requires an LM estimated with estimator="truncation" (factor-closed
    state set with per-state history metadata), estimate_phone_lm's
    default, and a tree whose pdfs do not depend on the right context.
    Raises ValueError otherwise.
    """
    if lifts_right_context(tree):
        raise ValueError(
            "the tree's pdfs depend on the right context (a triphone tree): the"
            " de Bruijn lift keys a pdf on the last two phones only"
        )
    if not getattr(phone_lm, "debruijn_compatible", False):
        raise ValueError(
            "phone LM is not de Bruijn compatible: estimate it with "
            "PhoneLmOptions(estimator='truncation')"
        )
    histories = getattr(phone_lm, "state_histories", None)
    if histories is None:
        raise ValueError("phone LM lacks state_histories metadata")
    order = getattr(phone_lm, "ngram_order")
    hist_len = order - 1
    P = tree.num_phones
    sigma = P + 1
    tail_len = 2 if (tree.context_dependent(0) or tree.context_dependent(1)) else 1
    m = max(hist_len, tail_len, 1)
    C = sigma**m
    D = sigma ** (m - 1)
    G = sigma**tail_len

    # ---- cls[c]: longest kept suffix of each context --------------------
    state_by_hist = {}
    for s, h in enumerate(histories):
        # histories use BOS=-1; contexts encode boundary as 0
        enc = tuple(0 if x == BOS else x for x in h)
        state_by_hist[enc] = s
    cls = np.full(C, state_by_hist.get((), -1), dtype=np.int32)
    c_all = np.arange(C, dtype=np.int64)
    for L in range(1, min(hist_len, m) + 1):
        tbl = np.full(sigma**L, -1, dtype=np.int32)
        for enc_h, s in state_by_hist.items():
            if len(enc_h) != L:
                continue
            idx = 0
            for x in enc_h:
                idx = idx * sigma + x
            tbl[idx] = s
        cand = tbl[c_all % sigma**L]
        cls = np.where(cand >= 0, cand, cls)

    digits = _context_digits(sigma, m)
    # valid = zeros only as a leading run
    nonzero_seen = np.zeros(C, dtype=bool)
    valid = np.ones(C, dtype=bool)
    for i in range(m):
        d = digits[:, i]
        valid &= ~(nonzero_seen & (d == 0))
        nonzero_seen |= d != 0
    last = digits[:, -1]

    # ---- W table ---------------------------------------------------------
    W_lm = np.zeros((phone_lm.num_states, sigma), dtype=np.float64)
    for s, a in phone_lm.all_arcs():
        if not (1 <= a.label <= P):
            raise ValueError("phone LM labels must be 1..num_phones")
        W_lm[s, a.label] += math.exp(a.weight)
    W_full = np.zeros((C, sigma), dtype=np.float64)
    ok = valid & (cls >= 0)
    W_full[ok] = W_lm[cls[ok]]
    W_full[:, 0] = 0.0

    # ---- pdf groups ------------------------------------------------------
    pdf0 = np.zeros(G, dtype=np.int32)
    pdf1 = np.zeros(G, dtype=np.int32)
    for g in range(G):
        q = g % sigma
        prev = (g // sigma) % sigma if tail_len == 2 else 0
        if q == 0:
            continue  # dead group: no emission enters a 0-tailed context
        pdf0[g] = tree.pdf(q, 0, prev)
        pdf1[g] = tree.pdf(q, 1, prev)

    # ---- initial probs: power iteration on the lift ----------------------
    # (kaldi chain-den-graph.cc SetInitialProbs role; iterating on the lift
    # projects to iterating on the quotient FST, so the limit matches)
    e_cont = math.exp(topo.log_continue)
    e_end = math.exp(topo.log_end)
    loop_valid = valid & (last >= 1)
    a = valid.astype(np.float64)
    l = loop_valid.astype(np.float64)
    tot = a.sum() + l.sum()
    a /= tot
    l /= tot
    W3_64 = W_full.reshape(sigma, D, sigma)
    for _ in range(num_iters):
        arr = np.einsum("rj,rjq->jq", a.reshape(sigma, D), W3_64).reshape(C)
        u = arr + l
        a, l = e_end * u, e_cont * u
        s = a.sum() + l.sum()
        if s <= 0:
            raise ValueError("de Bruijn transition operator lost all mass")
        a /= s
        l /= s
    if start_boost > 0.0:
        a *= 1.0 - start_boost
        l *= 1.0 - start_boost
        a[0] += start_boost  # all-boundary context, between-phones register

    return DeBruijnDenGraph(
        num_phones=P,
        num_pdfs=tree.num_pdfs,
        m=m,
        sigma=sigma,
        tail_len=tail_len,
        log_continue=topo.log_continue,
        log_end=topo.log_end,
        W3=W_full.reshape(sigma, D, sigma).astype(np.float32),
        pdf0_group=pdf0,
        pdf1_group=pdf1,
        init_bnd=a.astype(np.float32),
        init_loop=l.astype(np.float32),
        valid=valid,
        cls=cls,
    )


def materialize_lift_fst(g: DeBruijnDenGraph) -> tuple[Fst, np.ndarray]:
    """Expand the lift back into an explicit HMM acceptor over (pdf_id + 1)
    labels, plus its initial-prob vector — an exact sparse twin of the dense
    recursion, for oracle cross-checks (tests) and debugging.

    State numbering: bnd(c) = c, loop(c) = C + c."""
    C = g.num_contexts
    G = g.num_groups
    sigma = g.sigma
    D = C // sigma
    fst = Fst()
    fst.add_states(2 * C)
    W = g.W3.reshape(C, sigma)
    for c in range(C):
        if not g.valid[c]:
            continue
        fst.set_final(c, 0.0)
        tail = c % sigma
        if tail >= 1:
            fst.set_final(C + c, 0.0)
            pdf1 = int(g.pdf1_group[c % G])
            fst.add_arc(C + c, pdf1 + 1, g.log_continue, C + c)
            fst.add_arc(C + c, pdf1 + 1, g.log_end, c)
        for q in range(1, sigma):
            w = W[c, q]
            if w <= 0.0:
                continue
            c2 = (c % D) * sigma + q
            pdf0 = int(g.pdf0_group[c2 % G])
            lw = math.log(w)
            fst.add_arc(c, pdf0 + 1, lw + g.log_continue, C + c2)
            fst.add_arc(c, pdf0 + 1, lw + g.log_end, c2)
    init = np.concatenate([g.init_bnd, g.init_loop]).astype(np.float32)
    return fst, init
