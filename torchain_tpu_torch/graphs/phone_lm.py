"""Phone language-model estimation for the denominator graph.

Behavioral reference: kaldi/src/chain/language-model.cc
(`LanguageModelEstimator`, `LanguageModelOptions {ngram_order,
num_extra_lm_states, no_prune_ngram_order}`): an UN-SMOOTHED n-gram over
phone sequences with hard backoff — full-order n-gram counts are merged into
shorter-history states when the state budget is exceeded, and each kept
state's arc probabilities are maximum-likelihood count ratios (each state's
outgoing mass, including the end-of-sentence final weight, sums to one).

The output is an EPSILON-FREE acceptor over phones: backoff is realized by
pointing each arc at the longest kept suffix history ("hard" backoff by
count merging), not by epsilon backoff arcs.  This keeps the downstream
denominator-graph expansion epsilon-free, which is what the slot packing
of the denominator kernels wants.
"""

from __future__ import annotations

import dataclasses
import math
from collections import Counter, defaultdict

from torchain_tpu_torch.fstkit import Fst, connect

#: history padding symbol for beginning-of-sentence (never a real phone)
BOS = -1
#: "word" id used internally for end-of-sentence events (never a real phone)
EOS = 0

History = tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class PhoneLmOptions:
    """Mirrors Kaldi `LanguageModelOptions` (language-model.h)."""

    ngram_order: int = 4
    #: histories shorter than this order are never pruned
    no_prune_ngram_order: int = 2
    #: how many history states beyond the no-prune set to keep
    num_extra_lm_states: int = 2000
    #: estimator flavor:
    #:   "truncation" (default) — every kept history is a state carrying its
    #:     AGGREGATED ML distribution (all continuations of that suffix), and
    #:     the kept set is factor-closed (closed under contiguous substrings).
    #:     With this closure the LM automaton is exactly a quotient of the
    #:     de Bruijn graph over phone contexts.
    #:   "backoff" — Kaldi language-model.cc semantics: full-order counts
    #:     merge only into their LONGEST kept suffix, so interior states
    #:     carry leftover backoff mass only.
    estimator: str = "truncation"


def _suffixes(h: History):
    for i in range(len(h) + 1):
        yield h[i:]


def _factors(h: History):
    """All contiguous substrings of h (including the empty history), each
    once.  Factor-closure of the state set is what makes the truncation LM
    an exact de Bruijn quotient (graphs/debruijn.py)."""
    seen = set()
    for i in range(len(h) + 1):
        for j in range(i, len(h) + 1):
            f = h[i:j]
            if f not in seen:
                seen.add(f)
                yield f


def estimate_phone_lm(
    sentences: list[list[int]],
    opts: PhoneLmOptions = PhoneLmOptions(),
) -> Fst:
    """Estimate the denominator phone LM from training phone sequences.

    Returns an epsilon-free cyclic acceptor over phone labels (1-based) whose
    start state is state 0 and whose final weights carry the EOS mass.
    """
    order = opts.ngram_order
    if order < 1:
        raise ValueError("ngram_order must be >= 1")
    hist_len = order - 1

    # 1. full-order counts: history (len == hist_len, BOS-padded) -> Counter
    counts: dict[History, Counter] = defaultdict(Counter)
    for sent in sentences:
        if any(p < 1 for p in sent):
            raise ValueError("phones must be >= 1")
        h: History = (BOS,) * hist_len
        for w in list(sent) + [EOS]:
            counts[h][w] += 1
            if w != EOS:
                h = (h + (w,))[1:] if hist_len > 0 else ()
    if not counts:
        raise ValueError("no training sentences")

    # 2. aggregated counts for every suffix history: totals rank the pruning;
    #    per-event Counters are the truncation-mode ML distributions
    agg_total: Counter = Counter()
    agg_counts: dict[History, Counter] = defaultdict(Counter)
    for h, ctr in counts.items():
        tot = sum(ctr.values())
        for s in _suffixes(h):
            agg_total[s] += tot
            agg_counts[s].update(ctr)

    truncation = opts.estimator == "truncation"
    if opts.estimator not in ("truncation", "backoff"):
        raise ValueError(f"unknown estimator {opts.estimator!r}")
    closure = _factors if truncation else _suffixes

    # 3. kept set: all short histories + top-K longer ones.  Suffix-closed
    #    (backoff mode) or factor-closed (truncation mode: the extra prefix
    #    closure is what makes cls = longest-kept-suffix commute with
    #    appending a phone — the de Bruijn quotient property).
    no_prune_len = max(0, opts.no_prune_ngram_order - 1)
    kept: set[History] = {h for h in agg_total if len(h) <= no_prune_len}
    longer = sorted(
        (h for h in agg_total if len(h) > no_prune_len),
        key=lambda h: (-agg_total[h], len(h), h),
    )
    budget = opts.num_extra_lm_states
    for h in longer:
        if budget <= 0:
            break
        if h in kept:
            continue
        need = [s for s in closure(h) if s not in kept]
        if len(need) <= budget:
            kept.update(need)
            budget -= len(need)

    def longest_kept_suffix(h: History) -> History:
        for s in _suffixes(h):
            if s in kept:
                return s
        return ()

    # 4. state distributions
    if truncation:
        # every kept history carries its full aggregated ML distribution
        dist: dict[History, Counter] = {h: agg_counts[h] for h in kept}
    else:
        # Kaldi hard backoff: full-order counts merge into the longest kept
        # suffix only, so interior states carry leftover backoff mass
        dist = defaultdict(Counter)
        for h, ctr in counts.items():
            dist[longest_kept_suffix(h)].update(ctr)

    def resolve(h: History) -> History:
        """Longest kept suffix that actually has probability mass."""
        s = longest_kept_suffix(h)
        while s and not dist.get(s):
            s = s[1:]
        return s

    # 5. emit the FST
    fst = Fst()
    state_of: dict[History, int] = {}

    def state(h: History) -> int:
        if h not in state_of:
            state_of[h] = fst.add_state()
        return state_of[h]

    start_hist = resolve((BOS,) * hist_len)
    assert state(start_hist) == 0
    # breadth-first emission over reachable kept states
    stack = [start_hist]
    seen = {start_hist}
    while stack:
        h = stack.pop()
        ctr = dist.get(h)
        if not ctr:
            continue
        tot = sum(ctr.values())
        src = state(h)
        for w, c in sorted(ctr.items()):
            logp = math.log(c / tot)
            if w == EOS:
                fst.set_final(src, logp)
            else:
                nh = resolve((h + (w,))[-hist_len:] if hist_len > 0 else ())
                dst = state(nh)
                fst.add_arc(src, w, logp, dst)
                if nh not in seen:
                    seen.add(nh)
                    stack.append(nh)
    hist_of_state = [None] * fst.num_states
    for h, s in state_of.items():
        hist_of_state[s] = h
    out, keep = connect(fst, return_map=True)
    # metadata: per-state history tuple, plus whether the state set
    # supports the de Bruijn quotient (truncation closure)
    out.state_histories = [hist_of_state[old] for old in keep]
    out.debruijn_compatible = truncation
    out.ngram_order = order
    return out


def lm_log_prob(lm: Fst, sentence: list[int]) -> float:
    """Score one sentence under the LM (for tests/diagnostics).  Follows the
    deterministic arc for each phone; returns -inf if a phone is impossible."""
    state = 0
    logp = 0.0
    for w in sentence:
        nxt = [a for a in lm.arcs(state) if a.label == w]
        if not nxt:
            return float("-inf")
        # hard-backoff LMs are deterministic: at most one arc per label
        if len(nxt) != 1:
            raise ValueError("phone LM must be deterministic")
        logp += nxt[0].weight
        state = nxt[0].dst
    if not lm.is_final(state):
        return float("-inf")
    return logp + lm.final(state)
