"""The benchmark's own synthetic corpus, made from the seed: utterances with
per-frame features and phone alignments, the left-biphone tree, the phone
LM and the denominator FST as a plain arc list.

A frozen copy of the repository's synthetic-corpus generator
(`synthetic_dataset`, `estimate_phone_lm` in its truncation form,
`expand_lm_to_hmm` for a left-biphone tree with tied self-loops, `connect`,
`subsample_alignment` and `split_alignment_into_chunks`), kept here so that
no change to the program can move the benchmark's inputs.  It imports
nothing of the program.  Both sides get what it makes: the program as its
own objects (an FST, utterances, a tree), the reference as arrays.

One difference from the program's generator: the phone sequences, the LM
and the denominator graph come from a seed of the configuration's own, so
that every run's seed gives the same sizes (`make_corpus`), and a cell's
batch does not change the graph.
"""

from __future__ import annotations

import dataclasses
import math
from collections import Counter, defaultdict

import numpy as np

#: history padding symbol for beginning-of-sentence, and the end-of-sentence
#: event (neither is a real phone)
BOS = -1
EOS = 0
#: left-context symbol meaning "utterance boundary"
BOUNDARY = 0
#: the chain topology's transition log-probabilities (continue, end)
LOG_HALF = math.log(0.5)


@dataclasses.dataclass(frozen=True)
class Tree:
    """Left-biphone tree with self-loop pdfs tied across left contexts:
    pdf-class 0 (the first frame of a phone) depends on (phone, left),
    pdf-class 1 (every later frame) on the phone alone."""

    num_phones: int

    @property
    def num_pdfs(self) -> int:
        p = self.num_phones
        return p + p * (p + 1)

    def pdf(self, phone: int, pdf_class: int, left: int = BOUNDARY) -> int:
        p = self.num_phones
        if pdf_class == 1:
            return phone - 1
        return p + (phone - 1) * (p + 1) + left


@dataclasses.dataclass
class ArcList:
    """An acceptor as arrays: arc i goes src[i] -> dst[i] with `label[i]` and
    log-weight `logw[i]`; `final[s]` is state s's final log-weight (-inf:
    not final).  State 0 is the start."""

    num_states: int
    src: np.ndarray
    dst: np.ndarray
    label: np.ndarray
    logw: np.ndarray
    final: np.ndarray

    @property
    def num_arcs(self) -> int:
        return int(self.src.shape[0])


@dataclasses.dataclass
class Chunk:
    """One training chunk: its utterance, first output frame, alignment at
    the output rate (clipped to the chunk) and the phones either side."""

    utt: int
    c0: int
    ali: list
    left: int
    right: int


@dataclasses.dataclass
class Corpus:
    tree: Tree
    #: the model's input width: the spliced features and the i-vector
    feat_dim: int
    fsf: int
    phone_lm: ArcList
    #: the denominator HMM acceptor over pdf labels (label = pdf id, 0-based)
    den: ArcList
    #: per utterance: input-rate model inputs [T_in, feat_dim] and (phone,
    #: frames) pairs
    feats: list
    alignments: list
    chunks: list

    def chunk_feats(self, chunk: Chunk, t_out: int, left: int, right: int) -> np.ndarray:
        """Input-rate features of `chunk` with `left` and `right` frames of
        context, edge-padded (the loader's slicing)."""
        f = self.feats[chunk.utt]
        t0 = chunk.c0 * self.fsf - left
        t1 = (chunk.c0 + t_out) * self.fsf + right
        return f[np.clip(np.arange(t0, t1), 0, f.shape[0] - 1)]


# ---------------------------------------------------------------------------
# phone LM (truncation estimator) and its expansion into the HMM acceptor
# ---------------------------------------------------------------------------


def _suffixes(h):
    for i in range(len(h) + 1):
        yield h[i:]


def _factors(h):
    seen = set()
    for i in range(len(h) + 1):
        for j in range(i, len(h) + 1):
            f = h[i:j]
            if f not in seen:
                seen.add(f)
                yield f


def estimate_phone_lm(sentences, order: int, num_extra_states: int,
                      no_prune_order: int = 2) -> ArcList:
    """Un-smoothed n-gram over phone sequences with every kept history
    carrying its aggregated ML distribution, the kept set factor-closed
    (Kaldi's chain-est-phone-lm state budget); an epsilon-free acceptor
    over phones (1-based), trimmed, start state 0."""
    hist_len = order - 1
    counts = defaultdict(Counter)
    for sent in sentences:
        h = (BOS,) * hist_len
        for w in list(sent) + [EOS]:
            counts[h][w] += 1
            if w != EOS:
                h = (h + (w,))[1:] if hist_len > 0 else ()
    agg_total = Counter()
    agg_counts = defaultdict(Counter)
    for h, ctr in counts.items():
        tot = sum(ctr.values())
        for s in _suffixes(h):
            agg_total[s] += tot
            agg_counts[s].update(ctr)
    no_prune_len = max(0, no_prune_order - 1)
    kept = {h for h in agg_total if len(h) <= no_prune_len}
    longer = sorted((h for h in agg_total if len(h) > no_prune_len),
                    key=lambda h: (-agg_total[h], len(h), h))
    budget = num_extra_states
    for h in longer:
        if budget <= 0:
            break
        if h in kept:
            continue
        need = [s for s in _factors(h) if s not in kept]
        if len(need) <= budget:
            kept.update(need)
            budget -= len(need)
    dist = {h: agg_counts[h] for h in kept}

    def resolve(h):
        for s in _suffixes(h):
            if s in kept and dist.get(s):
                return s
        return ()

    state_of: dict = {}
    arcs, finals = [], {}

    def state(h) -> int:
        if h not in state_of:
            state_of[h] = len(state_of)
        return state_of[h]

    start = resolve((BOS,) * hist_len)
    state(start)
    stack, seen = [start], {start}
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
                finals[src] = logp
                continue
            nh = resolve((h + (w,))[-hist_len:] if hist_len > 0 else ())
            arcs.append((src, state(nh), w, logp))
            if nh not in seen:
                seen.add(nh)
                stack.append(nh)
    return connect(_arc_list(len(state_of), arcs, finals))


def expand_biphone(lm: ArcList, tree: Tree) -> ArcList:
    """The denominator HMM acceptor over pdf ids: the phone LM expanded with
    the chain topology (entry --pdf0--> loop | exit; loop --pdf1--> loop |
    exit, each 0.5) and the left phone tracked in the boundary states, as
    the tree's class-0 pdfs need it; trimmed, start state 0."""
    by_src = defaultdict(list)
    for s, d, w, lw in zip(lm.src, lm.dst, lm.label, lm.logw):
        by_src[int(s)].append((int(w), float(lw), int(d)))
    state_of: dict = {}
    arcs, finals = [], {}

    def state(key) -> int:
        if key not in state_of:
            state_of[key] = len(state_of)
        return state_of[key]

    start = ("bnd", 0, BOUNDARY)
    state(start)
    stack, seen = [start], {start}

    def visit(key) -> int:
        if key not in seen:
            seen.add(key)
            stack.append(key)
        return state(key)

    while stack:
        key = stack.pop()
        src = state(key)
        if key[0] == "bnd":
            _, ls, prev = key
            if np.isfinite(lm.final[ls]):
                finals[src] = float(lm.final[ls])
            for q, w, ld in by_src[ls]:
                pdf0 = tree.pdf(q, 0, prev)
                arcs.append((src, visit(("loop", ld, q)), pdf0, w + LOG_HALF))
                arcs.append((src, visit(("bnd", ld, q)), pdf0, w + LOG_HALF))
        else:
            _, ld, q = key
            pdf1 = tree.pdf(q, 1)
            arcs.append((src, src, pdf1, LOG_HALF))
            arcs.append((src, visit(("bnd", ld, q)), pdf1, LOG_HALF))
    return connect(_arc_list(len(state_of), arcs, finals))


def _arc_list(num_states: int, arcs, finals) -> ArcList:
    a = np.array(arcs, dtype=np.float64).reshape(-1, 4)
    final = np.full(num_states, -np.inf)
    for s, w in finals.items():
        final[s] = w
    return ArcList(num_states, a[:, 0].astype(np.int64), a[:, 1].astype(np.int64),
                   a[:, 2].astype(np.int64), a[:, 3].copy(), final)


def connect(fst: ArcList) -> ArcList:
    """Keep the states reachable from state 0 that reach a final state, in
    their order (state 0 stays the start)."""
    n = fst.num_states
    fwd = np.zeros(n, bool)
    fwd[0] = True
    bwd = np.isfinite(fst.final)
    for mask, a, b in ((fwd, fst.src, fst.dst), (bwd, fst.dst, fst.src)):
        while True:
            grow = np.zeros(n, bool)
            grow[b[mask[a]]] = True
            if not (grow & ~mask).any():
                break
            mask |= grow
    keep = fwd & bwd
    if not keep[0]:
        raise ValueError("the start state reaches no final state")
    new = np.cumsum(keep) - 1
    live = keep[fst.src] & keep[fst.dst]
    return ArcList(int(keep.sum()), new[fst.src[live]], new[fst.dst[live]],
                   fst.label[live], fst.logw[live], fst.final[keep])


# ---------------------------------------------------------------------------
# utterances and chunks
# ---------------------------------------------------------------------------


def _sentence(rng, frames_out: int, num_phones: int, durations):
    phones, durs, left = [], [], frames_out
    while left > 0:
        p = int(rng.integers(1, num_phones + 1))
        d = int(min(rng.integers(durations[0], durations[1] + 1), left))
        phones.append(p)
        durs.append(d)
        left -= d
    return phones, durs


def split_into_chunks(ali_out, chunk_frames: int):
    """Fixed-length chunks of an output-rate alignment: (c0, clipped
    alignment, left phone, right phone), a tail shorter than half a chunk
    dropped."""
    total = sum(d for _, d in ali_out)
    bounds, t0 = [], 0
    while t0 + chunk_frames <= total:
        bounds.append((t0, t0 + chunk_frames))
        t0 += chunk_frames
    if total - t0 >= chunk_frames // 2 and total - t0 > 0:
        bounds.append((t0, total))
    starts = np.cumsum([0] + [d for _, d in ali_out])
    out = []
    for c0, c1 in bounds:
        chunk, left, right = [], BOUNDARY, BOUNDARY
        for i, (p, _d) in enumerate(ali_out):
            s, e = int(starts[i]), int(starts[i + 1])
            if e <= c0:
                left = p
                continue
            if s >= c1:
                right = p
                break
            chunk.append((p, min(e, c1) - max(s, c0)))
        out.append((c0, chunk, left, right))
    return out


def _model_input(f: np.ndarray, splice: tuple, ivector: np.ndarray) -> np.ndarray:
    """Features [T, F] spliced at the frame offsets `splice` (edge frames
    repeated) with the utterance's i-vector appended to every frame: the
    input of a Kaldi recipe's first layer, Append(-1, 0, 1,
    ReplaceIndex(ivector, t, 0))."""
    t = np.arange(f.shape[0])
    cols = [f[np.clip(t + o, 0, f.shape[0] - 1)] for o in splice]
    if ivector.size:
        cols.append(np.broadcast_to(ivector.astype(np.float32), (f.shape[0], ivector.size)))
    return np.concatenate(cols, axis=1)


def make_corpus(seed: int, corpus_cfg: dict, chunk_frames: int, num_chunks: int) -> Corpus:
    """The corpus of one run.  Fixed by `corpus_seed`, whatever the run's
    seed: `num_utterances` phone sequences of `utterance_frames_out` output
    frames, the phone LM estimated on all of them (as Kaldi estimates it on
    the training alignments) and the denominator FST; a cell takes the
    first utterances that hold `num_chunks` chunks of `chunk_frames` frames.
    From `seed`: those utterances' order (so which chunks share a batch),
    the pdfs' feature means, the features' noise and each utterance's
    i-vector (`ivector_dim` normal entries; none without the key).  The
    features are spliced at the offsets `splice` ([0] without the key).  So every seed has the
    same graph and the same chunks, and so the same sizes, in another order."""
    fixed = np.random.default_rng(int(corpus_cfg["corpus_seed"]))
    tree = Tree(int(corpus_cfg["num_phones"]))
    fsf = int(corpus_cfg["frame_subsampling_factor"])
    durations = tuple(corpus_cfg["phone_durations_out"])
    feat_dim = int(corpus_cfg["feat_dim"])
    splice = tuple(corpus_cfg.get("splice", (0,)))
    ivector_dim = int(corpus_cfg.get("ivector_dim", 0))
    frames = int(corpus_cfg["utterance_frames_out"])
    sentences = [_sentence(fixed, frames, tree.num_phones, durations)
                 for _ in range(int(corpus_cfg["num_utterances"]))]
    lm = estimate_phone_lm([p for p, _ in sentences], int(corpus_cfg["lm_order"]),
                           int(corpus_cfg["lm_extra_states"]),
                           int(corpus_cfg["lm_no_prune_order"]))
    den = expand_biphone(lm, tree)
    per_utt = len(split_into_chunks([(1, frames)], chunk_frames))
    need = -(-num_chunks // per_utt)
    if need > len(sentences):
        raise ValueError(f"{num_chunks} chunks of {chunk_frames} frames asked of a corpus"
                         f" that holds {per_utt * len(sentences)}")
    rng = np.random.default_rng(seed)
    pdf_means = rng.normal(size=(tree.num_pdfs, feat_dim)).astype(np.float32)
    pdf_means *= float(corpus_cfg["pdf_mean_scale"])
    noise = float(corpus_cfg["feature_noise"])
    feats, alignments, chunks = [], [], []
    for u, i in enumerate(rng.permutation(need)):
        ali_out = list(zip(*sentences[i]))
        pdfs, left = [], BOUNDARY
        for p, d in ali_out:
            pdfs += [tree.pdf(p, 0, left)] * fsf + [tree.pdf(p, 1)] * (fsf * (d - 1))
            left = p
        f = pdf_means[np.array(pdfs)] + noise * rng.normal(
            size=(len(pdfs), feat_dim)).astype(np.float32)
        feats.append(_model_input(f, splice, rng.normal(size=ivector_dim)).astype(np.float32))
        alignments.append([(p, d * fsf) for p, d in ali_out])
        for c0, chunk, lc, rc in split_into_chunks(ali_out, chunk_frames):
            chunks.append(Chunk(u, c0, chunk, lc, rc))
    return Corpus(tree, len(splice) * feat_dim + ivector_dim, fsf, lm, den, feats, alignments,
                  chunks[:num_chunks])
