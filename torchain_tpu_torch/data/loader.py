"""Chunk loader: utterances + alignments -> packed training batches.

Replaces Kaldi's egs pipeline (nnet3-chain-get-egs | copy | shuffle |
merge): chunking, acoustic context padding, frame subsampling, supervision
compilation and minibatch merging all happen here, producing the same
LOGICAL records (features with left/right context at input rate +
per-chunk supervision FST tensors) without any ark/scp machinery.  Shape
contract: feats are [B, T_in, F] with T_in = T_out *
frame_subsampling_factor + left_context + right_context.

Also provides `synthetic_dataset`, a self-contained learnable toy corpus
(per-pdf Gaussian feature emissions over random phone sequences) used by
tests and chip_smoke.py.  For the same arguments and seed it yields the
same feats and supervision tables as the JAX package's loader.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from torchain_tpu_torch.fstkit import Fst, arcsort, compose
from torchain_tpu_torch.graphs import (
    ContextTree,
    PhoneLmOptions,
    SupervisionOptions,
    alignment_to_supervision_fst,
    compile_den_graph,
    compile_supervision,
    estimate_phone_lm,
    make_den_fst,
    make_normalization_fst,
)
from torchain_tpu_torch.graphs.den_graph import DenGraph, DenseDenGraph, make_dense_den_graph
from torchain_tpu_torch.graphs.e2e import (
    compile_e2e_supervision,
    make_e2e_supervision_fst,
    pad_and_stack_e2e,
)
from torchain_tpu_torch.graphs.supervision import (
    Supervision,
    frame_vocab_width,
    pad_and_stack_supervisions,
    split_alignment_into_chunks,
    subsample_alignment,
)


@dataclasses.dataclass
class ChainBatch:
    """One training minibatch (host numpy; the train step moves it on-device)."""

    feats: np.ndarray  # [B, T_in, F] float32
    sup: Supervision  # batched packed supervision (B leading dim)

    @property
    def batch_size(self) -> int:
        return self.feats.shape[0]


@dataclasses.dataclass
class Utterance:
    feats: np.ndarray  # [T_in_total, F] input-rate features
    alignment: list[tuple[int, int]]  # (phone, duration) at INPUT rate
    utt_id: str = ""


class ChainDataset:
    """Chunking + supervision-compiling batch iterator.

    Equal-length chunks are grouped so every batch shares T_out (Kaldi's
    merge-egs constraint), with supervision tensors padded to the batch-wide
    (max_states, max_arcs)."""

    def __init__(
        self,
        utts: list[Utterance],
        tree: ContextTree,
        norm_fst: Fst,
        chunk_frames_out: int = 50,
        left_context: int = 10,
        right_context: int = 10,
        sup_opts: SupervisionOptions = SupervisionOptions(),
        seed: int = 0,
        sup_round_states: int = 4,
        sup_round_arcs: int = 8,
    ):
        self.tree = tree
        self.norm_fst = norm_fst
        # the SAME normalization FST composes against every chunk: verify
        # eps-freeness + arcsort it ONCE
        if norm_fst.has_epsilons():
            raise ValueError("normalization FST must be epsilon-free")
        self._norm_ready = arcsort(norm_fst)
        #: compiled-supervision cache, chunk index -> Supervision | None;
        #: chunks are deterministic so entries stay valid for the dataset
        #: lifetime (Kaldi's analogue: egs are compiled once, offline)
        self._sup_cache: dict[int, Supervision | None] = {}
        self.left_context = left_context
        self.right_context = right_context
        self.sup_opts = sup_opts
        self.sup_round_states = sup_round_states
        self.sup_round_arcs = sup_round_arcs
        self.fsf = sup_opts.frame_subsampling_factor
        self.chunk_frames_out = chunk_frames_out
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        # each chunk: (utt_idx, c0_out, T_out, chunk_alignment, left_ctx,
        # right_ctx)
        self.chunks: list[tuple] = []
        self.utts = utts
        self.num_dropped = 0
        for ui, utt in enumerate(utts):
            ali_out = subsample_alignment(utt.alignment, self.fsf)
            for c0, chunk_ali, left_ctx, right_ctx in split_alignment_into_chunks(
                ali_out, chunk_frames_out, with_right_context=True
            ):
                t_out = sum(d for _, d in chunk_ali)
                self.chunks.append((ui, c0, t_out, chunk_ali, left_ctx, right_ctx))

    #: input-rate frame shift applied when slicing chunk features (Kaldi's
    #: nnet3-chain-copy-egs --frame-shift augmentation: each epoch reads the
    #: same chunks at a different sub-subsampling input phase, supervision
    #: unchanged; Trainer.fit cycles this through 0..fsf-1 across epochs)
    frame_shift: int = 0

    def _chunk_feats(self, utt: Utterance, c0_out: int, t_out: int) -> np.ndarray:
        """Input-rate features for chunk with context, edge-padded."""
        t0 = c0_out * self.fsf - self.left_context + self.frame_shift
        t1 = (c0_out + t_out) * self.fsf + self.right_context + self.frame_shift
        T = utt.feats.shape[0]
        idx = np.clip(np.arange(t0, t1), 0, T - 1)
        return utt.feats[idx]

    def _chunk_supervision(
        self,
        chunk_ali: list[tuple[int, int]],
        left_ctx: int,
        right_ctx: int = 0,
    ) -> Supervision | None:
        try:
            fst = alignment_to_supervision_fst(
                chunk_ali,
                self.tree,
                self.sup_opts,
                left_context_phone=left_ctx,
                right_context_phone=right_ctx,
            )
            return compile_supervision(
                compose(fst, self._norm_ready, b_ready=True),
                self.tree.num_pdfs,
            )
        except ValueError:
            self.num_dropped += 1  # Kaldi drops failed egs the same way
            return None

    def _sup_of(self, chunk_idx: int) -> Supervision | None:
        """Compiled supervision of chunk #chunk_idx, cached across epochs."""
        if chunk_idx not in self._sup_cache:
            _ui, _c0, _t, chunk_ali, left_ctx, right_ctx = self.chunks[chunk_idx]
            self._sup_cache[chunk_idx] = self._chunk_supervision(
                chunk_ali, left_ctx, right_ctx
            )
        return self._sup_cache[chunk_idx]

    def estimate_sup_caps(self) -> tuple[int, int, int, int]:
        """(max_states, max_arcs, max_frame_vocab, max_steady_arcs) over ALL
        chunks' compiled supervisions, rounded to the dataset's buckets: a
        fixed supervision padding, so every batch of a run has the same
        shapes.  Deterministic; O(dataset) supervision compiles (one-time,
        cached for the batches that follow)."""
        ms = ma = mv = mst = 1
        for ci in range(len(self.chunks)):
            sup = self._sup_of(ci)
            if sup is None:
                continue
            ms = max(ms, sup.max_states)
            ma = max(ma, sup.max_arcs)
            if sup.frame_vocab is not None:
                mv = max(mv, sup.frame_vocab.shape[1])
            else:
                mv = max(mv, frame_vocab_width(sup.in_src[None], sup.in_pdf[None]))
            if sup.steady_need is not None:
                mst = max(mst, int(sup.steady_need))
            elif sup.in_src.shape[0] > 1:  # steady (frames >= 1) arc width
                mst = max(mst, int((sup.in_src[1:] >= 0).sum(-1).max()))
        r = lambda x, m: ((x + m - 1) // m) * m  # noqa: E731
        return (
            r(ms, self.sup_round_states),
            r(ma, self.sup_round_arcs),
            r(mv, 8),
            r(mst, 4),
        )

    def batches(
        self,
        batch_size: int,
        shuffle: bool = True,
        drop_last: bool = True,
        epoch: int | None = None,
        sup_caps: tuple[int, int, int, int] | None = None,
    ):
        """Yield ChainBatch objects; chunks grouped by T_out.

        Passing `epoch` makes shuffling a pure function of (seed, epoch) so
        a resumed run replays the identical batch order.  `sup_caps` (from
        estimate_sup_caps: states, arcs, frame vocab, steady arcs) fixes the
        supervision padding exactly; a chunk beyond it raises."""
        pad_s, pad_k, pad_v, pad_st = sup_caps or (None,) * 4
        rng = (
            np.random.default_rng((self.seed, epoch)) if epoch is not None else self.rng
        )
        by_len: dict[int, list[int]] = {}
        for ci, c in enumerate(self.chunks):
            by_len.setdefault(c[2], []).append(ci)
        order = sorted(by_len)
        if shuffle:
            for k in order:
                rng.shuffle(by_len[k])
        for t_out in order:
            group = by_len[t_out]
            for i in range(0, len(group), batch_size):
                part = group[i : i + batch_size]
                if drop_last and len(part) < batch_size:
                    continue
                feats, sups = [], []
                for ci in part:
                    ui, c0, t, _ali, _lc, _rc = self.chunks[ci]
                    sup = self._sup_of(ci)
                    if sup is None:
                        continue
                    feats.append(self._chunk_feats(self.utts[ui], c0, t))
                    sups.append(sup)
                if not sups or (drop_last and len(sups) < batch_size):
                    continue
                yield ChainBatch(
                    feats=np.stack(feats).astype(np.float32),
                    sup=pad_and_stack_supervisions(
                        sups,
                        round_states_to=self.sup_round_states,
                        round_arcs_to=self.sup_round_arcs,
                        pad_states_to=pad_s,
                        pad_arcs_to=pad_k,
                        pad_vocab_to=pad_v,
                        pad_steady_to=pad_st,
                        # the device consumes pdf_local/frame_vocab only;
                        # the raw [B,T,S,K] pdf ids are dead weight here
                        materialize_pdf=False,
                    ),
                )


class E2eChainDataset:
    """Flat-start (alignment-free) batch iterator: whole utterances,
    bucketed to a common output length per batch (features and transcripts
    trimmed to the bucket boundary), cyclic e2e numerator graphs.

    Kaldi parity: the e2e egs path of flat-start LF-MMI
    (chain-generic-numerator.h); transcripts come from `Utterance.alignment`
    phone identities — durations are ignored."""

    def __init__(
        self,
        utts: list[Utterance],
        tree: ContextTree,
        norm_fst: Fst,
        chunk_frames_out: int = 50,
        left_context: int = 10,
        right_context: int = 10,
        frame_subsampling_factor: int = 3,
        seed: int = 0,
    ):
        self.tree = tree
        self.norm_fst = norm_fst
        if norm_fst.has_epsilons():  # check ONCE (compose gets b_ready=True)
            raise ValueError("normalization FST must be epsilon-free")
        self._norm_ready = arcsort(norm_fst)  # sort ONCE, reuse per utt
        self.left_context = left_context
        self.right_context = right_context
        self.fsf = frame_subsampling_factor
        self.chunk_frames_out = chunk_frames_out
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        self.utts = utts
        self.num_dropped = 0
        #: compiled e2e supervision per utterance index, reused across
        #: epochs (inputs are deterministic functions of the utterance and
        #: chunk_frames_out) — same role as ChainDataset's cross-epoch
        #: cache; entry-capped to bound host RAM on huge corpora
        self._sup_cache: dict[int, object] = {}
        self.sup_cache_size = 100_000

    def _sup_of(self, ui: int):
        """Compiled e2e supervision of utterance #ui, or None if it must be
        dropped; cached across epochs (first epoch pays compilation)."""
        if ui in self._sup_cache:
            return self._sup_cache[ui]
        utt = self.utts[ui]
        t_out = self.chunk_frames_out
        sup = None
        if utt.feats.shape[0] // self.fsf >= t_out:
            phones = [p for p, _ in utt.alignment]
            # trim: keep phones whose (approximate) start lies in the window
            durs_in = [d for _, d in utt.alignment]
            starts = np.cumsum([0] + durs_in)[:-1] // self.fsf
            keep = [p for p, s in zip(phones, starts) if s < t_out]
            if keep and len(keep) <= t_out:
                try:
                    fst = make_e2e_supervision_fst(
                        keep, self.tree, self._norm_ready, norm_ready=True
                    )
                    sup = compile_e2e_supervision(fst, t_out, self.tree.num_pdfs)
                except ValueError:
                    sup = None
        if len(self._sup_cache) < self.sup_cache_size:
            self._sup_cache[ui] = sup
        return sup

    def batches(
        self,
        batch_size: int,
        shuffle: bool = True,
        drop_last: bool = True,
        epoch: int | None = None,
        num_threads: int = 0,  # accepted for ChainDataset API parity;
        # e2e batches stack cached per-utterance supervisions, so the
        # threaded batch assembly has nothing to parallelize here
    ):
        rng = (
            np.random.default_rng((self.seed, epoch)) if epoch is not None else self.rng
        )
        order = list(range(len(self.utts)))
        if shuffle:
            rng.shuffle(order)
        t_out = self.chunk_frames_out
        feats_buf, sups_buf = [], []
        for ui in order:
            utt = self.utts[ui]
            first_visit = ui not in self._sup_cache
            sup = self._sup_of(ui)
            if sup is None:
                if first_visit:  # count each dropped utterance once
                    self.num_dropped += 1
                continue
            t0 = -self.left_context
            t1 = t_out * self.fsf + self.right_context
            idx = np.clip(np.arange(t0, t1), 0, utt.feats.shape[0] - 1)
            feats_buf.append(utt.feats[idx])
            sups_buf.append(sup)
            if len(sups_buf) == batch_size:
                yield ChainBatch(
                    feats=np.stack(feats_buf).astype(np.float32),
                    sup=pad_and_stack_e2e(sups_buf),
                )
                feats_buf, sups_buf = [], []
        if feats_buf and not drop_last:
            yield ChainBatch(
                feats=np.stack(feats_buf).astype(np.float32),
                sup=pad_and_stack_e2e(sups_buf),
            )


@dataclasses.dataclass
class SyntheticCorpus:
    utts: list[Utterance]
    tree: ContextTree
    den_graph: DenGraph
    dense_den: DenseDenGraph | None
    norm_fst: Fst
    den_fst: Fst
    feat_dim: int
    pdf_means: np.ndarray  # [num_pdfs, feat_dim] generative means
    phone_lm: Fst | None = None  # the estimated phone LM


def synthetic_dataset(
    num_utts: int = 32,
    num_phones: int = 8,
    feat_dim: int = 24,
    utt_frames_out: tuple[int, int] = (40, 80),
    frame_subsampling_factor: int = 3,
    context_width: int = 1,
    noise: float = 0.5,
    seed: int = 0,
    lm_order: int = 2,
    lm_extra_states: int = 200,
    sentences: list[list[int]] | None = None,
) -> SyntheticCorpus:
    """A learnable toy corpus: random phone sequences; each (input) frame's
    features are drawn from a Gaussian whose mean identifies the active
    pdf.  A model that learns the mapping drives the chain objective toward
    zero, so end-to-end tests/benches have a real learning signal.

    `sentences` overrides the random phone sequences (the word-corpus path
    supplies lexicon expansions); durations are still drawn per phone."""
    rng = np.random.default_rng(seed)
    tree = ContextTree(num_phones, context_width=context_width)
    # transcripts
    sents = []
    alis_out = []
    if sentences is not None:
        num_utts = len(sentences)
        for phones in sentences:
            durs = [int(rng.integers(1, 6)) for _ in phones]
            sents.append(list(phones))
            alis_out.append(list(zip(phones, durs)))
    else:
        for _ in range(num_utts):
            t_out = int(rng.integers(*utt_frames_out))
            phones = []
            durs = []
            left = t_out
            while left > 0:
                p = int(rng.integers(1, num_phones + 1))
                d = int(min(rng.integers(1, 6), left))
                phones.append(p)
                durs.append(d)
                left -= d
            sents.append(phones)
            alis_out.append(list(zip(phones, durs)))
    lm = estimate_phone_lm(
        sents, PhoneLmOptions(ngram_order=lm_order, num_extra_lm_states=lm_extra_states)
    )
    den_fst = make_den_fst(lm, tree)
    graph = compile_den_graph(den_fst, tree.num_pdfs)
    # the dense Moore form only while its V [S, E] stays small (the JAX
    # package's threshold): larger graphs use the slot-dense or sparse forms
    dense = make_dense_den_graph(graph) if graph.num_states <= 2500 else None
    norm = make_normalization_fst(den_fst, graph.initial_probs)

    pdf_means = rng.normal(size=(tree.num_pdfs, feat_dim)).astype(np.float32) * 2.0
    utts = []
    for ui, ali_out in enumerate(alis_out):
        # expand to input rate and emit per-frame features by active pdf
        ali_in = [(p, d * frame_subsampling_factor) for p, d in ali_out]
        frames = []
        left_phone = 0
        for p, d in ali_in:
            pdf0 = tree.pdf(p, 0, left_phone)
            pdf1 = tree.pdf(p, 1, left_phone)
            pdfs = [pdf0] * frame_subsampling_factor + [pdf1] * (
                d - frame_subsampling_factor
            )
            frames.extend(pdfs)
            left_phone = p
        feats = pdf_means[np.array(frames)] + rng.normal(
            size=(len(frames), feat_dim)
        ).astype(np.float32) * noise
        utts.append(
            Utterance(feats=feats.astype(np.float32), alignment=ali_in, utt_id=f"utt{ui}")
        )
    return SyntheticCorpus(
        utts=utts,
        tree=tree,
        den_graph=graph,
        dense_den=dense,
        norm_fst=norm,
        den_fst=den_fst,
        feat_dim=feat_dim,
        pdf_means=pdf_means,
        phone_lm=lm,
    )
