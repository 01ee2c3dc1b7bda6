"""Chunk loader: utterances + alignments -> packed training batches.

Replaces Kaldi's egs pipeline (nnet3-chain-get-egs | copy | shuffle |
merge): chunking, acoustic context padding, frame subsampling, supervision
compilation and minibatch merging all happen here, producing the same
LOGICAL records (features with left/right context at input rate +
per-chunk supervision FST tensors) without any ark/scp machinery.  Shape
contract: feats are [B, T_in, F] with T_in = T_out *
frame_subsampling_factor + left_context + right_context.

`ChainDataset` keeps each chunk's compiled supervision in a cache bounded
by count and bytes, compiles them all in forked worker processes
(`precompile`), writes and reads them as one .npz egs archive bound to the
dataset by a fingerprint (`save_egs`/`load_egs`; an archive written by
either package loads in the other), and builds batches on a thread pool
(`batches(num_threads=...)`).

Also provides `synthetic_dataset`, a self-contained learnable toy corpus
(per-pdf Gaussian feature emissions over random phone sequences) used by
tests and chip_smoke.py.  For the same arguments and seed it yields the
same feats and supervision tables as the JAX package's loader.
"""

from __future__ import annotations

import collections
import concurrent.futures as cf
import dataclasses
import hashlib
import os
import threading

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
    numerator_tables,
    pad_and_stack_supervisions,
    split_alignment_into_chunks,
    subsample_alignment,
)


#: the dataset a precompile worker compiles from (set in each worker)
_PRECOMPILE_DS = None


def _precompile_init(ds):
    global _PRECOMPILE_DS
    _PRECOMPILE_DS = ds


def _precompile_one(chunk_idx: int):
    _ui, _c0, _t, ali, lc, rc = _PRECOMPILE_DS.chunks[chunk_idx]
    return _PRECOMPILE_DS._chunk_supervision(ali, lc, rc)


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
        #: lifetime (Kaldi's analogue: egs are compiled once, offline).
        #: Bounded by BOTH an entry cap and a byte budget (packed tables run
        #: to hundreds of KB a chunk at production sizes).
        self._sup_cache: dict[int, Supervision | None] = {}
        self._sup_cache_bytes = 0
        #: guards num_dropped and the cache's byte count against the
        #: threaded batch builder (batches(num_threads > 1))
        self._stats_lock = threading.Lock()
        self.sup_cache_size = 100_000
        self.sup_cache_max_bytes = 4 * 1024**3
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
            with self._stats_lock:  # batches(num_threads > 1) builds concurrently
                self.num_dropped += 1  # Kaldi drops failed egs the same way
            return None

    def __getstate__(self):
        # a pickled dataset (a spawned worker's) gets a fresh lock: locks
        # do not pickle
        d = self.__dict__.copy()
        d["_stats_lock"] = None
        return d

    def __setstate__(self, d):
        self.__dict__.update(d)
        self._stats_lock = threading.Lock()

    def _sup_of(self, chunk_idx: int) -> Supervision | None:
        """Compiled supervision of chunk #chunk_idx, cached across epochs."""
        if chunk_idx in self._sup_cache:
            return self._sup_cache[chunk_idx]
        _ui, _c0, _t, chunk_ali, left_ctx, right_ctx = self.chunks[chunk_idx]
        sup = self._chunk_supervision(chunk_ali, left_ctx, right_ctx)
        self._cache_store(chunk_idx, sup)
        return sup

    def _sup_nbytes(self, sup) -> int:
        if sup is None:
            return 0
        return sum(
            a.nbytes
            for a in (
                sup.in_src,
                sup.in_pdf,
                sup.in_logw,
                sup.final_logw,
                sup.frame_vocab,
                sup.pdf_local,
            )
            if a is not None
        )

    def _cache_store(self, chunk_idx: int, sup) -> None:
        n = self._sup_nbytes(sup)
        with self._stats_lock:  # threaded batch builders store concurrently
            if chunk_idx in self._sup_cache:
                return  # a duplicate concurrent compile: count its bytes once
            if (
                len(self._sup_cache) < self.sup_cache_size
                and self._sup_cache_bytes + n <= self.sup_cache_max_bytes
            ):
                self._sup_cache[chunk_idx] = sup
                self._sup_cache_bytes += n

    def precompile(self, num_workers: int | None = None) -> int:
        """Compile every chunk's supervision in parallel worker processes
        and fill the cache (nnet3-chain-get-egs role: egs preparation is an
        offline, parallel stage in Kaldi).  Returns the number compiled.

        The workers are forked: they inherit the dataset (NumPy and the
        graph compilers only) and touch no device, so a parent that has
        already initialised CUDA may fork them; the supervisions come back
        pickled."""
        import multiprocessing as mp

        todo = [
            i
            for i in range(min(len(self.chunks), self.sup_cache_size))
            if i not in self._sup_cache
        ]
        if not todo:
            return 0
        num_workers = num_workers or min(16, os.cpu_count() or 1)
        if num_workers <= 1:
            for i in todo:
                self._sup_of(i)
            return len(todo)
        ctx = mp.get_context("fork")
        with cf.ProcessPoolExecutor(
            num_workers,
            mp_context=ctx,
            initializer=_precompile_init,
            initargs=(self,),
        ) as ex:
            for i, sup in zip(todo, ex.map(_precompile_one, todo, chunksize=8)):
                if sup is None:
                    self.num_dropped += 1
                self._cache_store(i, sup)
        return len(todo)

    # -- on-disk egs archives (nnet3-chain-get-egs archive role) ----------

    def egs_fingerprint(self) -> str:
        """Content hash binding an egs archive to THIS dataset: the chunk
        plan (utterance alignments, boundaries, contexts), supervision
        options, pdf map, and normalization FST.  A loaded archive whose
        fingerprint differs would silently supervise a different objective,
        so load_egs refuses it.  The JAX package hashes the same text, so an
        archive written by either package loads in the other."""
        h = hashlib.sha256()
        h.update(repr(self.sup_opts).encode())
        h.update(repr(self.chunks).encode())
        tree = self.tree
        if hasattr(tree, "pdf_map"):
            h.update(np.asarray(tree.pdf_map).tobytes())
        else:
            h.update(
                f"{type(tree).__name__}:{tree.num_pdfs}:"
                f"{getattr(tree, 'context_width', 0)}".encode()
            )
        f = self.norm_fst
        h.update(f"{f.num_states}".encode())
        for s in range(f.num_states):
            for a in f.arcs(s):
                h.update(f"{s},{a.label},{a.dst},{a.weight:.6g};".encode())
        return h.hexdigest()[:16]

    _EGS_FIELDS = ("in_src", "in_pdf", "in_logw", "final_logw", "num_states")
    #: numerator lookup tables (an archive without them has them derived
    #: on load — cheap per chunk)
    _EGS_TABLE_FIELDS = ("frame_vocab", "pdf_local")

    def save_egs(self, path) -> int:
        """Write every compiled supervision to one .npz archive — the
        on-disk form of Kaldi's cegs archives (nnet3-chain-get-egs writes
        them once; training jobs only read).  Chunks not yet compiled are
        compiled first (call precompile() beforehand to parallelize).
        Returns the number of chunks stored (dropped chunks are recorded
        as dropped so reloads don't recompile-and-refail them)."""
        arrays: dict[str, np.ndarray] = {}
        dropped = []
        n = 0
        for i in range(len(self.chunks)):
            sup = self._sup_of(i)
            if sup is None:
                dropped.append(i)
                continue
            for f in self._EGS_FIELDS:
                arrays[f"{i}_{f}"] = getattr(sup, f)
            for f in self._EGS_TABLE_FIELDS:
                if getattr(sup, f) is not None:
                    arrays[f"{i}_{f}"] = getattr(sup, f)
            arrays[f"{i}_meta"] = np.asarray(
                [
                    sup.num_frames,
                    sup.num_pdfs,
                    sup.max_states,
                    sup.max_arcs,
                    sup.steady_need if sup.steady_need is not None else -1,
                ],
                np.int64,
            )
            arrays[f"{i}_weight"] = np.asarray(sup.weight, np.float32)
            n += 1
        arrays["__fingerprint__"] = np.frombuffer(self.egs_fingerprint().encode(), np.uint8)
        arrays["__dropped__"] = np.asarray(dropped, np.int64)
        arrays["__num_chunks__"] = np.asarray([len(self.chunks)], np.int64)
        np.savez_compressed(path, **arrays)
        return n

    def load_egs(self, path) -> int:
        """Fill the supervision cache from a save_egs archive.  Refuses an
        archive whose fingerprint does not match this dataset (different
        corpus/tree/options).  Returns the number of chunks loaded."""
        with np.load(path) as z:
            fp = bytes(z["__fingerprint__"]).decode()
            if fp != self.egs_fingerprint():
                raise ValueError(
                    f"egs archive fingerprint {fp} does not match this "
                    f"dataset ({self.egs_fingerprint()}); the archive was "
                    "built from a different corpus, tree, normalization "
                    "FST, or supervision options"
                )
            if int(z["__num_chunks__"][0]) != len(self.chunks):
                raise ValueError("egs archive chunk count mismatch")
            for i in z["__dropped__"]:
                self._sup_cache[int(i)] = None
            n = 0
            for i in range(len(self.chunks)):
                if f"{i}_meta" not in z:
                    continue
                meta = z[f"{i}_meta"]
                sup = Supervision(
                    num_frames=int(meta[0]),
                    num_pdfs=int(meta[1]),
                    max_states=int(meta[2]),
                    max_arcs=int(meta[3]),
                    weight=float(z[f"{i}_weight"]),
                    **{f: z[f"{i}_{f}"] for f in self._EGS_FIELDS},
                    **{f: z[f"{i}_{f}"] for f in self._EGS_TABLE_FIELDS if f"{i}_{f}" in z},
                )
                if len(meta) > 4 and int(meta[4]) >= 0:
                    sup.steady_need = int(meta[4])
                if sup.frame_vocab is None or sup.steady_need is None:
                    # an archive without the tables: derive them once here
                    fv, pl, need = numerator_tables(sup.in_src, sup.in_pdf)
                    sup.frame_vocab, sup.pdf_local, sup.steady_need = fv, pl, need
                self._cache_store(i, sup)
                n += 1
        return n

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
        process_index: int | None = None,
        process_count: int | None = None,
        sup_caps: tuple[int, int, int, int] | None = None,
        num_threads: int = 0,
    ):
        """Yield ChainBatch objects; chunks grouped by T_out.

        Passing `epoch` makes shuffling a pure function of (seed, epoch) so
        a resumed run replays the identical batch order.  `sup_caps` (from
        estimate_sup_caps: states, arcs, frame vocab, steady arcs) fixes the
        supervision padding exactly; a chunk beyond it raises.

        `num_threads > 1` builds batches on a thread pool, in order: the
        per-batch NumPy pad/stack work releases the GIL, so the host-side
        egs assembly scales past one core while the device runs.  Use after
        precompile()/load_egs — concurrent cache misses would compile the
        same supervision twice (correct, just wasted work).

        Data parallelism: with `process_index`/`process_count`, `batch_size`
        is the GLOBAL batch; every process plans the identical (seed,
        epoch)-deterministic global batch sequence but builds only its
        contiguous batch_size/process_count rows.  `sup_caps` (from
        estimate_sup_caps, identical everywhere) fixes the supervision
        padding so shapes agree across processes without communication; a
        chunk whose supervision fails to compile becomes a weight-0 copy of
        a sibling row (keeping shapes) instead of shrinking the batch."""
        multi = process_count is not None and process_count > 1
        pi = process_index or 0
        pc = process_count or 1
        if multi:
            if batch_size % pc:
                raise ValueError(f"global batch {batch_size} not divisible by {pc}")
            if sup_caps is None:
                raise ValueError("multi-host batches need sup_caps (estimate_sup_caps)")
            if not drop_last:
                raise ValueError("multi-host batches require drop_last=True")
        local_bs = batch_size // pc
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
        parts: list[list[int]] = []
        for t_out in order:
            group = by_len[t_out]
            for i in range(0, len(group), batch_size):
                part = group[i : i + batch_size]
                if drop_last and len(part) < batch_size:
                    continue
                if multi:
                    part = part[pi * local_bs : (pi + 1) * local_bs]
                parts.append(part)

        def build(part: list[int]) -> ChainBatch | None:
            feats, sups, holes = [], [], []
            for ci in part:
                ui, c0, t, _ali, _lc, _rc = self.chunks[ci]
                sup = self._sup_of(ci)
                if sup is None:
                    if multi:
                        # a placeholder keeps the local shapes; filled with
                        # a weight-0 copy of a sibling row below
                        holes.append(len(sups))
                        feats.append(None)
                        sups.append(None)
                    continue
                feats.append(self._chunk_feats(self.utts[ui], c0, t))
                sups.append(sup)
            if multi and holes:
                donor = next((k for k, s in enumerate(sups) if s is not None), None)
                if donor is None:
                    # every row of this rank failed: the ranks would disagree
                    # on the batch, so abort rather than hang a collective
                    raise ValueError(
                        "all rows of a host shard failed supervision "
                        "compilation; regenerate data or lower batch size"
                    )
                for h in holes:
                    s = dataclasses.replace(sups[donor])
                    s.weight = 0.0
                    sups[h] = s
                    feats[h] = feats[donor]
            if not sups or (drop_last and len(sups) < (local_bs if multi else batch_size)):
                return None
            return ChainBatch(
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

        # serial by default here; Trainer.fit passes TrainerConfig.
        # loader_threads, which defaults to half the host's cores (at most 4)
        num_threads = min(num_threads or 0, os.cpu_count() or 1)
        if num_threads > 1:
            with cf.ThreadPoolExecutor(num_threads) as ex:
                pending: collections.deque = collections.deque()
                for part in parts:
                    pending.append(ex.submit(build, part))
                    while len(pending) > num_threads + 1:
                        b = pending.popleft().result()
                        if b is not None:
                            yield b
                while pending:
                    b = pending.popleft().result()
                    if b is not None:
                        yield b
        else:
            for part in parts:
                b = build(part)
                if b is not None:
                    yield b


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
