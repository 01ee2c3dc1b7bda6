"""Supervision (numerator) compilation: alignments -> per-chunk FSTs ->
packed per-frame arc tensors.

Behavioral reference: kaldi/src/chain/chain-supervision.{h,cc} —
`AlignmentToProtoSupervision` (per-frame allowed phones with tolerance),
`ProtoSupervisionToSupervision`, `SupervisionSplitter` (fixed-length chunk
splitting), `AddWeightToSupervisionFst` (normalization-FST composition), and
`SortBreadthFirstSearch` (time-sorting).  Re-designed: instead of generic
FST composition chains, the tolerance lattice is constructed directly as an
acyclic acceptor over pdf labels whose states are (frame, phone-index,
in-self-loop) triples — the same language, built in one pass.

The packed output is frame-local: every state gets a (frame, slot) position
and in-arcs are padded to fixed (max_states_per_frame, max_arcs_per_state),
giving dense [T, S, K] tensors a `lax.scan` / Pallas kernel consumes with no
host-side raggedness.  This replaces Kaldi's NnetChainSupervision egs
payload (kaldi/src/nnet3/nnet-chain-example.h).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from torchain_tpu_torch.fstkit import Fst, bfs_time_sort, connect
from torchain_tpu_torch.fstkit.fst import NEG_INF
from torchain_tpu_torch.graphs.topology import BOUNDARY, ContextTree


@dataclasses.dataclass(frozen=True)
class SupervisionOptions:
    """Mirrors the relevant slice of Kaldi's SupervisionOptions
    (chain-supervision.h): tolerances are in OUTPUT frames (Kaldi's
    --left-tolerance/--right-tolerance are input frames; divide by
    frame_subsampling_factor)."""

    left_tolerance: int = 2
    right_tolerance: int = 2
    frame_subsampling_factor: int = 3
    #: per-sequence weight on the objective (Supervision::weight)
    weight: float = 1.0


# ---------------------------------------------------------------------------
# alignment handling
# ---------------------------------------------------------------------------


def subsample_alignment(
    ali: list[tuple[int, int]], factor: int
) -> list[tuple[int, int]]:
    """Convert (phone, duration) pairs from input frame rate to output rate.
    Every phone keeps at least one output frame; total output length is
    ceil(total_input / factor), matching Kaldi's frame-subsampling of
    alignments in nnet3-chain-get-egs."""
    if factor == 1:
        return list(ali)
    total_in = sum(d for _, d in ali)
    total_out = -(-total_in // factor)
    if total_out < len(ali):
        raise ValueError(
            f"cannot subsample: {len(ali)} phones need >= {len(ali)} of "
            f"{total_out} output frames"
        )
    # proportional allocation with >= 1 frame per phone (largest remainder),
    # so no phone is dropped even when shorter than `factor` input frames
    exact = [d / factor for _, d in ali]
    durs = [max(1, int(x)) for x in exact]
    rema = [(x - int(x), i) for i, x in enumerate(exact)]
    deficit = total_out - sum(durs)
    if deficit > 0:
        for _, i in sorted(rema, key=lambda r: (-r[0], r[1]))[:deficit]:
            durs[i] += 1
        deficit = total_out - sum(durs)
    while deficit > 0:  # leftover frames: give to the longest phones
        j = max(range(len(durs)), key=lambda i: durs[i])
        durs[j] += 1
        deficit -= 1
    while deficit < 0:  # too many minimum-1 bumps: shrink the longest phones
        j = max(range(len(durs)), key=lambda i: durs[i])
        if durs[j] <= 1:
            raise ValueError("cannot fit phones into subsampled frames")
        durs[j] -= 1
        deficit += 1
    return [(p, d) for (p, _), d in zip(ali, durs)]


def split_alignment_into_chunks(
    ali: list[tuple[int, int]],
    chunk_frames: int,
    min_tail: int | None = None,
    with_right_context: bool = False,
) -> list[tuple]:
    """Split an output-rate alignment into fixed-length chunks.

    Returns (chunk_start_frame, chunk_alignment, left_context_phone) tuples
    — plus a trailing right_context_phone (the phone after the chunk, 0 at
    utterance end; triphone trees need it) when `with_right_context` —
    boundary phones clipped to the chunk window, mirroring what Kaldi's
    SupervisionSplitter does at the FST level (chain-supervision.cc).
    A final partial chunk shorter than `min_tail` (default chunk_frames//2)
    is dropped, as Kaldi recipes drop short leftovers."""
    if min_tail is None:
        min_tail = chunk_frames // 2
    total = sum(d for _, d in ali)
    bounds = []
    t0 = 0
    while t0 + chunk_frames <= total:
        bounds.append((t0, t0 + chunk_frames))
        t0 += chunk_frames
    if total - t0 >= min_tail and total - t0 > 0:
        bounds.append((t0, total))

    starts = np.cumsum([0] + [d for _, d in ali])
    chunks = []
    for c0, c1 in bounds:
        chunk: list[tuple[int, int]] = []
        left_ctx = BOUNDARY
        right_ctx = BOUNDARY
        for i, (p, d) in enumerate(ali):
            s, e = int(starts[i]), int(starts[i + 1])
            if e <= c0:
                left_ctx = p
                continue
            if s >= c1:
                right_ctx = p
                break
            chunk.append((p, min(e, c1) - max(s, c0)))
        if with_right_context:
            chunks.append((c0, chunk, left_ctx, right_ctx))
        else:
            chunks.append((c0, chunk, left_ctx))
    return chunks


# ---------------------------------------------------------------------------
# tolerance-lattice construction
# ---------------------------------------------------------------------------


def alignment_to_supervision_fst(
    ali: list[tuple[int, int]],
    tree: ContextTree,
    opts: SupervisionOptions = SupervisionOptions(),
    num_frames: int | None = None,
    left_context_phone: int = BOUNDARY,
    right_context_phone: int = BOUNDARY,
) -> Fst:
    """Build the unweighted tolerance lattice over pdf+1 labels.

    Accepts every pdf sequence realizing the chunk's phone sequence where
    phone i starts within [start_i - left_tolerance, start_i +
    right_tolerance] (clamped), the first phone starts at frame 0, and the
    last phone ends at the final frame — `AlignmentToProtoSupervision` +
    `ProtoSupervisionToSupervision` semantics in one pass.
    """
    if not ali:
        raise ValueError("empty alignment")
    T = num_frames if num_frames is not None else sum(d for _, d in ali)
    N = len(ali)
    phones = [p for p, _ in ali]
    starts = np.cumsum([0] + [d for _, d in ali])[:-1]
    start_min = [max(0, int(s) - opts.left_tolerance) for s in starts]
    start_max = [min(T - 1, int(s) + opts.right_tolerance) for s in starts]
    start_min[0] = 0
    start_max[0] = 0  # first phone starts the chunk
    # each phone needs >= 1 frame; tighten windows so N-i phones fit after i
    for i in range(N):
        start_max[i] = min(start_max[i], T - (N - i))
        start_min[i] = max(start_min[i], i)
        if start_min[i] > start_max[i]:
            raise ValueError(f"phone {i} cannot fit its tolerance window")

    left_of = [left_context_phone] + phones[:-1]
    right_of = phones[1:] + [right_context_phone]

    fst = Fst()
    state_of: dict[tuple[int, int, int], int] = {}

    def state(t: int, i: int, in_loop: int) -> int:
        key = (t, i, in_loop)
        if key not in state_of:
            state_of[key] = fst.add_state()
        return state_of[key]

    assert state(0, 0, 0) == 0
    stack = [(0, 0, 0)]
    seen = {(0, 0, 0)}

    def visit(t: int, i: int, in_loop: int) -> int:
        if (t, i, in_loop) not in seen:
            seen.add((t, i, in_loop))
            stack.append((t, i, in_loop))
        return state(t, i, in_loop)

    while stack:
        t, i, in_loop = stack.pop()
        if in_loop == 2:  # terminal marker state: no outgoing arcs
            continue
        src = state(t, i, in_loop)
        # at (t, i, in_loop): about to emit frame t with phone i
        pdf_class = 1 if in_loop else 0
        pdf = tree.pdf(phones[i], pdf_class, left_of[i], right_of[i])
        label = pdf + 1
        nt = t + 1
        if nt == T:
            if i == N - 1:
                dst = visit(nt, i, 2)  # terminal marker state
                fst.add_arc(src, label, 0.0, dst)
                fst.set_final(dst, 0.0)
            continue
        # continue current phone
        fst.add_arc(src, label, 0.0, visit(nt, i, 1))
        # advance to next phone if it may start at frame nt
        if i + 1 < N and start_min[i + 1] <= nt <= start_max[i + 1]:
            fst.add_arc(src, label, 0.0, visit(nt, i + 1, 0))
    return connect(fst)


# ---------------------------------------------------------------------------
# packing
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Supervision:
    """Packed per-frame numerator tensors for one chunk (host numpy).

    For frame step t (0-based, t in [0, T)), states live at frame t+1 with
    `num_states[t+1] <= max_states` occupying slots [0, num_states[t+1]);
    `in_src[t, s, k]` is the slot (at frame t) of the k-th in-arc of slot s
    (at frame t+1), `in_pdf` its pdf id, `in_logw` its log-weight
    (normalization-FST mass; 0 if uncomposed), -1/-inf padding otherwise.
    Frame 0 has exactly one state (slot 0, the start).
    `final_logw[s]` is the final weight of frame-T slot s (-inf padding).
    """

    num_frames: int
    num_pdfs: int
    max_states: int
    max_arcs: int
    #: scalar for a single chunk; float32 [B] after pad_and_stack (per-sequence
    #: Supervision::weight semantics survive merging, as in Kaldi merged egs)
    weight: "float | np.ndarray"
    in_src: np.ndarray  # int32 [T, S, K]
    in_pdf: np.ndarray  # int32 [T, S, K]
    in_logw: np.ndarray  # float32 [T, S, K]
    final_logw: np.ndarray  # float32 [S]
    num_states: np.ndarray  # int32 [T+1]
    #: forced per-frame pdf-vocabulary width for DeviceSupervision.from_host
    #: (multi-host batches need cross-process shape agreement; None = derive
    #: from the batch content)
    vocab_cap: "int | None" = None
    #: forced steady-frame (frames >= 1) arc-slot width, same agreement role
    steady_cap: "int | None" = None
    #: precomputed numerator tables (the gather-free numerator's per-frame
    #: pdf vocabulary — see ops.device_graphs._frame_vocab_tables).  Built
    #: once per chunk here at compile time and merely padded/stacked per
    #: batch, so the warm-epoch loader does no per-batch sorting: at
    #: production scale the per-batch derivation cost ~140 ms vs an ~12 ms
    #: device step.  [T, W] / [T, S, K] per chunk; [B, T, W] / [B, T, S, K]
    #: after pad_and_stack.  None on legacy egs archives (from_host then
    #: derives them per batch as before).
    frame_vocab: "np.ndarray | None" = None
    pdf_local: "np.ndarray | None" = None
    #: max in-degree over frames >= 1 (exact, unrounded); batch max after
    #: pad_and_stack.  Frame 0 concentrates the normalization FST's initial
    #: fan-in, so the scans run frames >= 1 at this narrower width.
    steady_need: "int | None" = None
    #: optional per-frame DERIVATIVE weights ([T] per chunk; [B, T] after
    #: pad_and_stack): NnetChainSupervision.deriv_weights semantics ([K]
    #: nnet-chain-training.cc ApplyDerivWeights) — they scale the rows of
    #: the output derivative (and the xent term), NOT the objf.  None =
    #: all-ones (the in-process pipeline never generates them; they arrive
    #: via cegs interchange).
    frame_weights: "np.ndarray | None" = None


def compile_supervision(
    fst: Fst,
    num_pdfs: int,
    weight: float = 1.0,
    max_states: int | None = None,
    max_arcs: int | None = None,
) -> Supervision:
    """Pack a (possibly normalization-composed) supervision FST.

    The FST must be acyclic, epsilon-free, with every arc advancing exactly
    one frame (true of alignment_to_supervision_fst output and its
    composition with the normalization FST)."""
    fst = connect(fst)
    if fst.num_states == 0:
        raise ValueError(
            "empty supervision FST — if this came from normalization-FST "
            "composition, the denominator graph does not accept this "
            "chunk's pdf sequence (Kaldi drops such egs too); check "
            "left-context handling and phone-LM coverage"
        )
    fst = bfs_time_sort(fst)
    S = fst.num_states
    # frame of each state = BFS depth (all paths to a state share a length)
    frame = [-1] * S
    frame[0] = 0
    for s in range(S):
        for a in fst.arcs(s):
            if frame[a.dst] == -1:
                frame[a.dst] = frame[s] + 1
            elif frame[a.dst] != frame[s] + 1:
                raise ValueError("supervision FST is not frame-synchronous")
    T = max(frame)
    # slot assignment per frame
    slot = [0] * S
    counts = [0] * (T + 1)
    for s in range(S):
        f = frame[s]
        slot[s] = counts[f]
        counts[f] += 1
    if counts[0] != 1:
        raise ValueError("expected a unique start state at frame 0")
    S_max = max_states or max(counts)
    if max(counts) > S_max:
        raise ValueError(f"needs {max(counts)} state slots > max_states={S_max}")

    # in-arc lists per destination state
    in_arcs: list[list[tuple[int, int, float]]] = [[] for _ in range(S)]
    for s, a in fst.all_arcs():
        in_arcs[a.dst].append((slot[s], a.label - 1, a.weight))
    K = max_arcs or max((len(x) for x in in_arcs), default=1)
    if max(len(x) for x in in_arcs) > K:
        raise ValueError("in-degree exceeds max_arcs")

    in_src = np.full((T, S_max, K), -1, dtype=np.int32)
    in_pdf = np.zeros((T, S_max, K), dtype=np.int32)
    in_logw = np.full((T, S_max, K), NEG_INF, dtype=np.float32)
    final_logw = np.full((S_max,), NEG_INF, dtype=np.float32)
    for s in range(S):
        f = frame[s]
        if f == 0:
            continue
        for k, (src_slot, pdf, w) in enumerate(in_arcs[s]):
            if pdf < 0 or pdf >= num_pdfs:
                raise ValueError("pdf out of range in supervision FST")
            in_src[f - 1, slot[s], k] = src_slot
            in_pdf[f - 1, slot[s], k] = pdf
            in_logw[f - 1, slot[s], k] = w
    for s in range(S):
        if fst.is_final(s):
            if frame[s] != T:
                raise ValueError("final state not at last frame")
            final_logw[slot[s]] = fst.final(s)

    frame_vocab, pdf_local, steady_need = numerator_tables(in_src, in_pdf)
    return Supervision(
        num_frames=T,
        num_pdfs=num_pdfs,
        max_states=S_max,
        max_arcs=K,
        weight=weight,
        in_src=in_src,
        in_pdf=in_pdf,
        in_logw=in_logw,
        final_logw=final_logw,
        num_states=np.array(counts + [0] * (T + 1 - len(counts)), dtype=np.int32),
        frame_vocab=frame_vocab,
        pdf_local=pdf_local,
        steady_need=steady_need,
    )


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _frame_vocab_tables(in_src, in_pdf, round_to=8, pad_to=None):
    """Per-frame pdf vocabulary for the gather-free numerator.

    For each (b, t) row the supervision references only a handful of
    distinct pdfs (the tolerance window's phones x pdf-classes), so the
    emission lookup can run over a tiny local vocabulary instead of the
    full [B, T, P] output: returns

      frame_vocab [B, T, W] int32 — the sorted distinct pdfs of each row
        (0-padded; unused slots harmlessly re-reference pdf 0),
      pdf_local   [B, T, S, K] int32 — each arc's index into its row's
        vocabulary (0 for pad arcs).

    W is the max row cardinality rounded up to `round_to` (or forced to
    `pad_to` for cross-process shape agreement)."""
    B, T, S, K = in_pdf.shape
    flat = in_pdf.reshape(B * T, S * K).astype(np.int64)
    valid = in_src.reshape(B * T, S * K) >= 0
    BIG = np.int64(1) << 40
    a = np.where(valid, flat, BIG)
    order = np.argsort(a, axis=1, kind="stable")
    s = np.take_along_axis(a, order, axis=1)
    new = np.ones_like(s, dtype=bool)
    new[:, 1:] = s[:, 1:] != s[:, :-1]
    new &= s < BIG
    rank_sorted = np.cumsum(new, axis=1) - 1  # rank among row uniques
    w_needed = int(max(1, new.sum(axis=1).max()))
    W = ((w_needed + round_to - 1) // round_to) * round_to
    if pad_to is not None:
        if w_needed > pad_to:
            raise ValueError(
                f"frame pdf vocabulary needs {w_needed} slots > "
                f"vocab cap {pad_to}"
            )
        W = pad_to
    vocab = np.zeros((B * T, W), dtype=np.int32)
    rows = np.broadcast_to(np.arange(B * T)[:, None], s.shape)
    vocab[rows[new], rank_sorted[new]] = s[new].astype(np.int32)
    local_sorted = np.where(s < BIG, np.maximum(rank_sorted, 0), 0)
    local = np.zeros_like(flat, dtype=np.int32)
    np.put_along_axis(local, order, local_sorted.astype(np.int32), axis=1)
    return vocab.reshape(B, T, W), local.reshape(B, T, S, K)


def frame_vocab_width(in_src, in_pdf) -> int:
    """Max distinct pdfs in any (b, t) supervision row (unrounded) — the
    quantity estimate_sup_caps aggregates for multi-host shape agreement."""
    B, T, S, K = in_pdf.shape
    flat = in_pdf.reshape(B * T, S * K).astype(np.int64)
    valid = in_src.reshape(B * T, S * K) >= 0
    BIG = np.int64(1) << 40
    s = np.sort(np.where(valid, flat, BIG), axis=1)
    new = np.ones_like(s, dtype=bool)
    new[:, 1:] = s[:, 1:] != s[:, :-1]
    new &= s < BIG
    return int(max(1, new.sum(axis=1).max()))


def numerator_tables(
    in_src: np.ndarray, in_pdf: np.ndarray
) -> tuple[np.ndarray, np.ndarray, int]:
    """Per-chunk numerator lookup tables for the gather-free scan.

    For each frame row t, the supervision references only a handful of
    distinct pdfs; returns

      frame_vocab [T, W] int32 — sorted distinct pdfs of each row
        (0-padded; W = max row cardinality, unrounded, >= 1),
      pdf_local   [T, S, K] int32 — each arc's index into its row's
        vocabulary (0 for pad arcs),
      steady_need int — max in-degree over frames >= 1 (>= 1).

    Delegates to _frame_vocab_tables (the batched derivation, with a
    singleton batch axis and round_to=1 for the exact per-chunk width) so
    the two can never drift apart — DeviceSupervision.from_host mixes
    precomputed and fallback-derived tables."""
    vocab, local = _frame_vocab_tables(in_src[None], in_pdf[None], round_to=1)
    steady = 1
    if in_src.shape[0] > 1:
        steady = int(max(1, (in_src[1:] >= 0).sum(-1).max()))
    return vocab[0], local[0], steady


def pad_and_stack_supervisions(
    sups: list[Supervision],
    round_states_to: int = 1,
    round_arcs_to: int = 1,
    pad_states_to: int | None = None,
    pad_arcs_to: int | None = None,
    pad_vocab_to: int | None = None,
    pad_steady_to: int | None = None,
    materialize_pdf: bool = True,
) -> Supervision:
    """Stack per-chunk supervisions into batched tensors with shared padding
    (the moral equivalent of nnet3-chain-merge-egs producing
    num_sequences>1).  `round_states_to`/`round_arcs_to` bucket the padded
    (S, K) dims so consecutive batches share shapes and the jitted train
    step doesn't recompile per batch.  `pad_states_to`/`pad_arcs_to` force
    EXACT padded sizes (multi-host batches need shapes that agree across
    processes without communicating); chunks exceeding them raise.

    Index dtypes are narrowed at STACK time (in_src/pdf_local int16 when
    the ranges fit) so DeviceSupervision.from_host converts nothing — the
    loader fill bandwidth halves and the hot path stops copying twice.
    `materialize_pdf=False` (the loader hot path) skips building the
    [B, T, S, K] in_pdf entirely when every chunk carries precomputed
    numerator tables: the device consumes only pdf_local/frame_vocab, so
    the raw pdf ids are dead weight there (ops/device_graphs.py)."""
    if not sups:
        raise ValueError("no supervisions")
    T = max(s.num_frames for s in sups)
    if any(s.num_frames != T for s in sups):
        raise ValueError("all chunks in a batch must share num_frames")
    S = _round_up(max(s.max_states for s in sups), round_states_to)
    K = _round_up(max(s.max_arcs for s in sups), round_arcs_to)
    if pad_states_to is not None:
        if S > pad_states_to:
            raise ValueError(f"chunk needs {S} states > pad_states_to={pad_states_to}")
        S = pad_states_to
    if pad_arcs_to is not None:
        if K > pad_arcs_to:
            raise ValueError(f"chunk needs {K} arcs > pad_arcs_to={pad_arcs_to}")
        K = pad_arcs_to
    P = sups[0].num_pdfs
    B = len(sups)
    tables = [
        s.frame_vocab is not None and s.pdf_local is not None for s in sups
    ]
    src_dt = np.int16 if S <= np.iinfo(np.int16).max else np.int32
    in_src = np.full((B, T, S, K), -1, dtype=src_dt)
    in_pdf = (
        None
        if (not materialize_pdf and all(tables))
        else np.zeros((B, T, S, K), dtype=np.int32)
    )
    in_logw = np.full((B, T, S, K), NEG_INF, dtype=np.float32)
    final_logw = np.full((B, S), NEG_INF, dtype=np.float32)
    num_states = np.zeros((B, T + 1), dtype=np.int32)
    for b, s in enumerate(sups):
        in_src[b, :, : s.max_states, : s.max_arcs] = s.in_src
        if in_pdf is not None:
            in_pdf[b, :, : s.max_states, : s.max_arcs] = s.in_pdf
        in_logw[b, :, : s.max_states, : s.max_arcs] = s.in_logw
        final_logw[b, : s.max_states] = s.final_logw
        num_states[b] = s.num_states
    # stack the precomputed numerator tables (pad slots stay 0 — the
    # "strictly increasing valid prefix, 0-padded" vocab invariant and the
    # pdf_local=0-for-pad-arcs convention both survive padding unchanged)
    frame_vocab = pdf_local = None
    steady_need: int | None = None
    if all(tables):
        w_needed = max(s.frame_vocab.shape[1] for s in sups)
        W = _round_up(w_needed, 8)
        if pad_vocab_to is not None:
            if w_needed > pad_vocab_to:
                raise ValueError(
                    f"frame pdf vocabulary needs {w_needed} slots > "
                    f"vocab cap {pad_vocab_to}"
                )
            W = pad_vocab_to
        loc_dt = np.int16 if W <= np.iinfo(np.int16).max else np.int32
        frame_vocab = np.zeros((B, T, W), dtype=np.int32)
        pdf_local = np.zeros((B, T, S, K), dtype=loc_dt)
        for b, s in enumerate(sups):
            frame_vocab[b, :, : s.frame_vocab.shape[1]] = s.frame_vocab
            pdf_local[b, :, : s.max_states, : s.max_arcs] = s.pdf_local
        steady_need = max(int(s.steady_need or 1) for s in sups)
    frame_weights = None
    if any(s.frame_weights is not None for s in sups):
        frame_weights = np.ones((B, T), dtype=np.float32)
        for b, s in enumerate(sups):
            if s.frame_weights is not None:
                frame_weights[b] = s.frame_weights
    return Supervision(
        num_frames=T,
        num_pdfs=P,
        max_states=S,
        max_arcs=K,
        weight=np.array([s.weight for s in sups], dtype=np.float32),
        in_src=in_src,
        in_pdf=in_pdf,
        in_logw=in_logw,
        final_logw=final_logw,
        num_states=num_states,
        vocab_cap=pad_vocab_to,
        steady_cap=pad_steady_to,
        frame_vocab=frame_vocab,
        pdf_local=pdf_local,
        steady_need=steady_need,
        frame_weights=frame_weights,
    )
