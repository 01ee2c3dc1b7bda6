"""Numerator (supervision) forward-backward: log-semiring recursion over the
packed per-frame arc tensors, with kernels K5 (vocabulary gather) and K6
(vocabulary scatter).

Behavioral reference: kaldi/src/chain/chain-numerator.cc
(`NumeratorComputation`).  Port of torchain_tpu/ops/num_scan.py in the
configuration whose steady-frame recursion runs as a loop over frames
(TORCHAIN_NUM_RESIDENT=0 there): y is indexed once per pass through a
per-frame pdf vocabulary (`DeviceSupervision.frame_vocab` [B, T, W],
W << P), the recursions work in that small space, and the occupancies are
expanded back to pdf space once at the end.

  * K5 `vocab_gather`: ysmall [B, T, W] = y[b, t, frame_vocab[b, t, w]]
  * K6 `vocab_scatter`: vocabulary occupancies [T, B, W] -> [B, T, P]

On a CUDA tensor each is one launch of csrc/num_vocab.cu; on a CPU tensor
the plain PyTorch version beside it runs.  The recursions between them are
plain PyTorch (the resident numerator kernels K3/K4 are a later port).
"""

from __future__ import annotations

import torch

from torchain_tpu_torch import kernels
from torchain_tpu_torch.ops.device_graphs import DeviceSupervision

NEG_INF = float("-inf")


# ---------------------------------------------------------------------------
# K5: vocabulary gather
# ---------------------------------------------------------------------------


def vocab_gather_plain(y: torch.Tensor, frame_vocab: torch.Tensor) -> torch.Tensor:
    """Plain K5: y [B, T, P] f32, frame_vocab [B, T, W] int32 -> [B, T, W]."""
    return torch.gather(y, 2, frame_vocab.long())


def vocab_gather(y: torch.Tensor, frame_vocab: torch.Tensor) -> torch.Tensor:
    """K5.  Launches csrc/num_vocab.cu:vocab_gather on a CUDA tensor."""
    if y.device.type == "cpu":
        return vocab_gather_plain(y, frame_vocab)
    B, T, P = y.shape
    W = frame_vocab.shape[-1]
    kernels.check_tensor("y", y, torch.float32)
    kernels.check_tensor("frame_vocab", frame_vocab, torch.int32, (B, T, W))
    out = torch.empty((B, T, W), device=y.device, dtype=torch.float32)
    lib = kernels.library("num_vocab")
    err = lib.vocab_gather(
        y.data_ptr(), frame_vocab.data_ptr(), out.data_ptr(), B, T, P, W,
        kernels.stream_of(y.device),
    )
    kernels.check(lib, err, "vocab_gather")
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
    T, B, W = gsm_t.shape
    kernels.check_tensor("gsm_t", gsm_t, torch.float32)
    kernels.check_tensor("frame_vocab", frame_vocab, torch.int32, (B, T, W))
    gamma = torch.empty((B, T, P), device=gsm_t.device, dtype=torch.float32)
    lib = kernels.library("num_vocab")
    err = lib.vocab_scatter(
        gsm_t.data_ptr(), frame_vocab.data_ptr(), gamma.data_ptr(), B, T, P, W,
        kernels.stream_of(gsm_t.device),
    )
    kernels.check(lib, err, "vocab_scatter")
    vocab_scatter.launches += 1
    return gamma


vocab_scatter.launches = 0


# ---------------------------------------------------------------------------
# recursions
# ---------------------------------------------------------------------------


def _emit(ysm: torch.Tensor, pdf_local: torch.Tensor) -> torch.Tensor:
    """ysm [B, W], pdf_local [B, S, K] -> emission log-probs [B, S, K]."""
    B = ysm.shape[0]
    return ysm.gather(1, pdf_local.reshape(B, -1)).view(pdf_local.shape)


def _select_src(x: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """x [B, S], src [B, S, K] (values in [0, S), -1 = pad) -> [B, S, K]
    with x[b, src[b, s, k]] (pad slots yield -inf)."""
    B = x.shape[0]
    sel = x.gather(1, src.clamp(min=0).reshape(B, -1)).view(src.shape)
    return torch.where(src >= 0, sel, NEG_INF)


def _fwd_step(alpha, ysm, src, lpdf, logw):
    vals = _select_src(alpha, src) + torch.where(
        src >= 0, logw + _emit(ysm, lpdf), 0.0
    )
    return torch.logsumexp(vals, dim=-1)


def num_forward(
    y: torch.Tensor,  # [B, T, P]
    sup: DeviceSupervision,
    ysmall: torch.Tensor | None = None,  # [B, T, W] shared with the backward
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (log_prob [B], alphas [T+1, B, S])."""
    B, T, _ = y.shape
    S = sup.max_states
    if ysmall is None:
        ysmall = vocab_gather(y.float().contiguous(), sup.frame_vocab)
    a0 = torch.full((B, S), NEG_INF, device=y.device)
    a0[:, 0] = 0.0
    # frame 0 at full K (the normalization FST's initial fan-in); frames
    # >= 1 at the much narrower steady-arc width (arcs are left-packed)
    alphas = [a0, _fwd_step(a0, ysmall[:, 0], sup.in_src0, sup.pdf_local0, sup.in_logw0)]
    for t in range(1, T):
        alphas.append(
            _fwd_step(
                alphas[-1], ysmall[:, t], sup.in_src_r[:, t - 1],
                sup.pdf_local_r[:, t - 1], sup.in_logw_r[:, t - 1],
            )
        )
    log_p = torch.logsumexp(alphas[-1] + sup.final_logw, dim=-1)
    return log_p, torch.stack(alphas)


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

    One reverse loop carries beta [B, S] and emits per-frame occupancies
    already reduced to vocabulary space [B, W]; K6 expands them to pdf
    space once."""
    B, T, P = y.shape
    S = sup.max_states
    W = sup.frame_vocab.shape[-1]
    valid = torch.isfinite(log_p)
    safe_logp = torch.where(valid, log_p, 0.0)
    if ysmall is None:
        ysmall = vocab_gather(y.float().contiguous(), sup.frame_vocab)
    iota_s = torch.arange(S, device=y.device)
    iota_w = torch.arange(W, device=y.device)

    def step(beta, ysm, src, lpdf, logw, alpha_t):
        # beta: log-betas of frame t+1 states; emit the occupancies of
        # frame t and pull beta back to frame t states
        arc_w = torch.where(src >= 0, logw + _emit(ysm, lpdf), NEG_INF) + beta[:, :, None]
        hit_src = src[..., None] == iota_s  # [B, S, K, S']
        prev = torch.logsumexp(
            torch.where(hit_src, arc_w[..., None], NEG_INF), dim=(1, 2)
        )  # [B, S'] — per-src-slot stabilized pullback
        sel_alpha = _select_src(alpha_t, src)
        post = torch.where(
            valid[:, None, None],
            torch.exp(sel_alpha + arc_w - safe_logp[:, None, None]),
            0.0,
        )  # [B, S, K] per-arc occupancies
        hit_w = lpdf[..., None] == iota_w  # [B, S, K, W]
        gsm = torch.where(hit_w, post[..., None], 0.0).sum((1, 2))
        return prev, gsm  # gsm [B, W]

    gsm = [None] * T
    beta = sup.final_logw
    for t in range(T - 1, 0, -1):
        beta, gsm[t] = step(
            beta, ysmall[:, t], sup.in_src_r[:, t - 1], sup.pdf_local_r[:, t - 1],
            sup.in_logw_r[:, t - 1], alphas[t],
        )
    _, gsm[0] = step(
        beta, ysmall[:, 0], sup.in_src0, sup.pdf_local0, sup.in_logw0, alphas[0]
    )
    return vocab_scatter(torch.stack(gsm), sup.frame_vocab, P)
