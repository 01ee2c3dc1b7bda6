"""Forced alignment: transcript + chain-head outputs -> phone durations.

Behavioral reference: the align stage of Kaldi recipes (gmm-align-compiled /
ali-to-phones): Viterbi over the transcript's linear HMM with the model's
pseudo-loglikes, reading per-frame phone attributions off the best path.
This closes the alignment bootstrap loop in-repo (SURVEY.md section 7 hard
part 1): flat-start e2e training needs no alignments, and this module then
GENERATES alignments from the flat-start model so the tolerance-lattice
(standard) supervision path can take over — the classic two-stage ladder,
no GMM system required.

Port of torchain_tpu/eval/align.py: the DP is the same NumPy; the model's
forward runs in torch on the model's device.
"""

from __future__ import annotations

import numpy as np

from torchain_tpu_torch.fstkit.fst import NEG_INF
from torchain_tpu_torch.graphs.topology import BOUNDARY, ChainTopology, ContextTree


def force_align(
    loglikes: np.ndarray,  # [T, P] chain-head outputs
    phones: list[int],
    tree: ContextTree,
    topo: ChainTopology = ChainTopology(),
    left_context_phone: int = BOUNDARY,
) -> list[tuple[int, int]]:
    """Viterbi-align `phones` to T frames; returns (phone, duration) pairs
    summing to T (every phone >= 1 frame).  Raises if T < len(phones).

    Direct DP over the linear transcript HMM (states = phone index x
    {entry-done}, the same lattice alignment_to_supervision_fst encodes
    with infinite tolerance): O(T * N) with backpointers.
    """
    T, P = loglikes.shape
    N = len(phones)
    if N == 0:
        raise ValueError("empty transcript")
    if T < N:
        raise ValueError(f"{N} phones cannot align to {T} frames")
    left = [left_context_phone] + phones[:-1]
    right = phones[1:] + [0]
    pdf0 = np.array([tree.pdf(p, 0, l, r) for p, l, r in zip(phones, left, right)])
    pdf1 = np.array([tree.pdf(p, 1, l, r) for p, l, r in zip(phones, left, right)])
    lc, le = topo.log_continue, topo.log_end

    # score[i] = best log-prob of being "inside phone i" after frame t
    score = np.full(N, NEG_INF)
    # entered[t, i] = True if the best path entered phone i at frame t
    entered = np.zeros((T, N), dtype=bool)
    score[0] = loglikes[0, pdf0[0]]
    entered[0, 0] = True
    for t in range(1, T):
        stay = score + lc + loglikes[t, pdf1]  # continue phone i
        adv = np.full(N, NEG_INF)
        adv[1:] = score[:-1] + le + loglikes[t, pdf0[1:]]  # enter phone i
        better = adv > stay
        entered[t] = better
        score = np.where(better, adv, stay)
    if not np.isfinite(score[N - 1]):
        raise ValueError("alignment infeasible")

    # backtrace: walk frames backwards tracking the active phone index
    durs = np.zeros(N, dtype=int)
    i = N - 1
    for t in range(T - 1, -1, -1):
        durs[i] += 1
        if entered[t, i]:
            i -= 1
    assert i == -1, "backtrace did not consume all phones"
    return [(p, int(d)) for p, d in zip(phones, durs)]


def with_context(feats: np.ndarray, frame_subsampling_factor: int, left_context: int,
                 right_context: int) -> np.ndarray:
    """An utterance's features as the model's input [1, T_in', F]: the
    frames the output frames need, with the acoustic context padded by
    repeating the first and the last frame."""
    T_in = feats.shape[0]
    t_out = T_in // frame_subsampling_factor
    idx = np.clip(
        np.arange(-left_context, t_out * frame_subsampling_factor + right_context),
        0,
        T_in - 1,
    )
    return np.ascontiguousarray(feats[idx][None])


def align_corpus(
    forward_fn,
    utts,
    tree: ContextTree,
    frame_subsampling_factor: int = 3,
    left_context: int = 0,
    right_context: int = 0,
) -> list[list[tuple[int, int]]]:
    """Force-align every utterance with a trained model; returns INPUT-rate
    alignments (durations multiplied back by the subsampling factor,
    remainder on the last phone) ready for `Utterance.alignment` /
    ChainDataset.

    `forward_fn(feats)` is train/step.py `make_forward_fn(model)`: it
    takes a [1, T_in, F] tensor on the model's device (`device`, read off
    the model's parameters where `forward_fn` has a `device` attribute)
    and returns the chain head's output [1, T_out, P].  One utterance at a
    time, at B=1, as the reference does."""
    import torch

    device = getattr(forward_fn, "device", None)
    out = []
    for utt in utts:
        T_in = utt.feats.shape[0]
        x = with_context(utt.feats, frame_subsampling_factor, left_context, right_context)
        y = forward_fn(torch.as_tensor(x, device=device))[0].float().cpu().numpy()
        phones = [p for p, _ in utt.alignment]
        ali_out = force_align(y, phones, tree)
        ali_in = [(p, d * frame_subsampling_factor) for p, d in ali_out]
        deficit = T_in - sum(d for _, d in ali_in)
        if deficit != 0:
            p, d = ali_in[-1]
            ali_in[-1] = (p, max(1, d + deficit))
        out.append(ali_in)
    return out
