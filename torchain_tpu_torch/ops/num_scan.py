"""Numerator (supervision) forward-backward: log-semiring recursion over the
packed per-frame arc tensors, with kernels K5 (vocabulary gather) and K6
(vocabulary scatter) around the resident recursions K3/K4.

Behavioral reference: kaldi/src/chain/chain-numerator.cc
(`NumeratorComputation`).  Port of torchain_tpu/ops/num_scan.py: y is
indexed once per pass through a per-frame pdf vocabulary
(`DeviceSupervision.frame_vocab` [B, T, W], W << P), the recursions work in
that small space, and the occupancies are expanded back to pdf space once
at the end.

  * K5 `vocab_gather`: ysmall [B, T, W] = y[b, t, frame_vocab[b, t, w]]
  * K6 `vocab_scatter`: vocabulary occupancies [T, B, W] -> [B, T, P]

Frame 0 (the normalization FST's wide initial fan-in) is one step of plain
PyTorch at the full arc width; frames 1..T-1 go through
ops/num_resident.py (`steady_forward` K3, `steady_backward` K4) at the
narrower steady width.  On a CUDA tensor every kernel is one launch of its
source under csrc/; on a CPU tensor the plain PyTorch version beside it
runs.
"""

from __future__ import annotations

import torch

from torchain_tpu_torch import kernels
from torchain_tpu_torch.ops import num_resident
from torchain_tpu_torch.ops.device_graphs import DeviceSupervision

NEG_INF = float("-inf")


# ---------------------------------------------------------------------------
# K5: vocabulary gather
# ---------------------------------------------------------------------------


def vocab_gather_plain(y: torch.Tensor, frame_vocab: torch.Tensor) -> torch.Tensor:
    """Plain K5: y [B, T, P] f32, frame_vocab [B, T, W] int32 -> [B, T, W]."""
    return torch.gather(y, 2, frame_vocab.long())


def _check_vocab(frame_vocab: torch.Tensor, B: int, T: int) -> int:
    """The vocabulary K5 and K6 take, checked by shape, type and device (a
    `DeviceSupervision` fixes it; `check_tensor` guards the tensors that
    change every call).  Returns W."""
    if frame_vocab.dim() != 3 or frame_vocab.shape[:2] != (B, T):
        raise ValueError(f"frame_vocab: expected [{B}, {T}, W], got {tuple(frame_vocab.shape)}")
    if frame_vocab.dtype != torch.int32 or not frame_vocab.is_cuda:
        raise TypeError(f"frame_vocab: expected int32 on the card, got {frame_vocab.dtype}"
                        f" on {frame_vocab.device}")
    if not frame_vocab.is_contiguous():
        raise ValueError("frame_vocab: expected a contiguous tensor")
    return frame_vocab.shape[2]


def vocab_gather(y: torch.Tensor, frame_vocab: torch.Tensor) -> torch.Tensor:
    """K5.  Launches csrc/num_vocab.cu:vocab_gather on a CUDA tensor."""
    if y.device.type == "cpu":
        return vocab_gather_plain(y, frame_vocab)
    kernels.check_tensor("y", y, torch.float32)
    B, T, P = y.shape
    W = _check_vocab(frame_vocab, B, T)
    out = torch.empty((B, T, W), device=y.device, dtype=torch.float32)
    err = kernels.entry("num_vocab", "vocab_gather")(
        y.data_ptr(), frame_vocab.data_ptr(), out.data_ptr(), B, T, P, W,
        kernels.stream_of(y.device),
    )
    if err:
        kernels.check(kernels.library("num_vocab"), err, "vocab_gather")
    vocab_gather.launches += 1
    return out


vocab_gather.launches = 0


# ---------------------------------------------------------------------------
# K6: vocabulary scatter
# ---------------------------------------------------------------------------


def vocab_scatter_plain(
    gsm_t: torch.Tensor, frame_vocab: torch.Tensor, P: int
) -> torch.Tensor:
    """Plain K6: gsm_t [T, B, W] f32 -> gamma [B, T, P], accumulating over
    the W slots.  Pad slots repeat pdf 0 but carry exactly 0.0, so the
    accumulation leaves a real pdf-0 occupancy intact."""
    g = gsm_t.transpose(0, 1)  # [B, T, W]
    gamma = g.new_zeros(g.shape[:2] + (P,))
    return gamma.scatter_add_(2, frame_vocab.long(), g)


def vocab_scatter(
    gsm_t: torch.Tensor, frame_vocab: torch.Tensor, P: int
) -> torch.Tensor:
    """K6.  Launches csrc/num_vocab.cu:vocab_scatter on a CUDA tensor."""
    if gsm_t.device.type == "cpu":
        return vocab_scatter_plain(gsm_t, frame_vocab, P)
    kernels.check_tensor("gsm_t", gsm_t, torch.float32)
    T, B, W = gsm_t.shape
    if _check_vocab(frame_vocab, B, T) != W:
        raise ValueError(f"frame_vocab: expected W={W}, got {frame_vocab.shape[2]}")
    gamma = torch.empty((B, T, P), device=gsm_t.device, dtype=torch.float32)
    err = kernels.entry("num_vocab", "vocab_scatter")(
        gsm_t.data_ptr(), frame_vocab.data_ptr(), gamma.data_ptr(), B, T, P, W,
        kernels.stream_of(gsm_t.device),
    )
    if err:
        kernels.check(kernels.library("num_vocab"), err, "vocab_scatter")
    vocab_scatter.launches += 1
    return gamma


vocab_scatter.launches = 0


# ---------------------------------------------------------------------------
# recursions
# ---------------------------------------------------------------------------


def num_forward(
    y: torch.Tensor,  # [B, T, P]
    sup: DeviceSupervision,
    ysmall: torch.Tensor | None = None,  # [B, T, W] shared with the backward
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (log_prob [B], alphas [T+1, B, S])."""
    B, S = y.shape[0], sup.max_states
    if ysmall is None:
        ysmall = vocab_gather(y.float().contiguous(), sup.frame_vocab)
    a0 = torch.full((B, S), NEG_INF, device=y.device)
    a0[:, 0] = 0.0
    # frame 0 at full K (the normalization FST's initial fan-in); frames
    # >= 1 at the much narrower steady-arc width (arcs are left-packed)
    alpha1 = num_resident.forward_step(
        a0, ysmall[:, 0], sup.in_src0, sup.pdf_local0, sup.in_logw0
    )
    # (with T = 1 there are none: alpha1 passes through, nothing is launched)
    aT, rest = num_resident.steady_forward(
        alpha1, sup.in_src_r, sup.pdf_local_r, sup.in_logw_r, ysmall[:, 1:],
        pre=sup.kernel_pre,
    )
    log_p = torch.logsumexp(aT + sup.final_logw, dim=-1)
    return log_p, torch.cat([a0[None], alpha1[None], rest])


def num_backward(
    y: torch.Tensor,  # [B, T, P]
    sup: DeviceSupervision,
    log_p: torch.Tensor,  # [B]
    alphas: torch.Tensor,  # [T+1, B, S]
    ysmall: torch.Tensor | None = None,
) -> torch.Tensor:
    """Returns gamma [B, T, P] = d(log_prob)/dy (numerator occupancies).
    Sequences with non-finite log_p yield exactly zero gamma (the caller
    applies the numeric-failure policy).

    The reverse recursion carries beta [B, S] and emits per-frame
    occupancies already reduced to vocabulary space [B, W]; K6 expands
    them to pdf space once."""
    P = y.shape[-1]
    if ysmall is None:
        ysmall = vocab_gather(y.float().contiguous(), sup.frame_vocab)
    # frames T-1..1 at the steady arc width; the wide frame-0 step runs
    # once outside (mirrors num_forward)
    beta1, gsm_rest = num_resident.steady_backward(
        sup.in_src_r, sup.pdf_local_r, sup.in_logw_r, ysmall[:, 1:],
        alphas[1:-1], sup.final_logw, log_p, pre=sup.kernel_pre,
    )
    _, gsm0 = num_resident.backward_step(
        beta1, ysmall[:, 0], sup.in_src0, sup.pdf_local0, sup.in_logw0, alphas[0], log_p
    )
    return vocab_scatter(torch.cat([gsm0[None], gsm_rest]), sup.frame_vocab, P)
