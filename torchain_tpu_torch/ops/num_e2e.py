"""End-to-end (generic) numerator forward-backward, around kernels K8f and
K8b.

Behavioral reference: kaldi/src/chain/chain-generic-numerator.{h,cc}
(`GenericNumeratorComputation`): full log-space alpha/beta over cyclic
per-sequence numerator graphs (self-loops allowed, states do not map to
frames).  Port of torchain_tpu/ops/num_e2e.py.  The arc tables are constant
over time, so the recursions carry only [B, S] state vectors.

  * each sequence's graph references a small pdf vocabulary `vocab`
    [B, Pv]; y -> ysmall [B, T, Pv] is one gather;
  * each arc's local pdf id expands ysmall to per-arc emissions ylocal
    [B, T, S, K] (a second gather), which both passes share;
  * the per-arc posteriors are summed back to vocabulary space (one
    product with the arcs' one-hot vocabulary slots) and then to pdf space
    (a `scatter_add_` of distinct slots).

The JAX package writes these four index operations as one-hot matrix
products because its accelerator gathers badly; they are outside its
kernels, so here the gathers are plain PyTorch indexing, and exact.  The
sum over arcs stays a product (float32, TF32 off): a `scatter_add_` of many
arcs into one slot sums in the order its atomic adds land on the card,
which changes from run to run, and Adam turns that into other parameters a
few steps later.  The recursions are ops/num_resident.py `e2e_forward_resident` (K8f) and
`e2e_backward_resident` (K8b): kernels on CUDA tensors, their plain
versions on CPU tensors, and no switch between forms.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from torchain_tpu_torch.graphs.e2e import E2eSupervision
from torchain_tpu_torch.graphs.supervision import _frame_vocab_tables
from torchain_tpu_torch.ops import num_resident
from torchain_tpu_torch.ops.den_debruijn import full_float32
from torchain_tpu_torch.ops.device_graphs import _to_device

NEG_INF = float("-inf")


def _seq_vocab_tables(in_src, in_pdf, round_to=8, pad_to=None):
    """Per-sequence pdf vocabulary: returns (vocab [B, Pv] int32 0-padded,
    pdf_local [B, S, K] int32 indices into vocab, 0 for pad arcs).  The
    per-frame tables of the standard supervision, for one "frame" that
    holds the whole time-constant graph.  Pv is the most distinct pdfs of
    a sequence rounded up to `round_to`, or `pad_to` where given (a batch
    that needs more raises)."""
    vocab, local = _frame_vocab_tables(in_src[:, None], in_pdf[:, None], round_to=round_to,
                                       pad_to=pad_to)
    return vocab[:, 0], local[:, 0]


@dataclasses.dataclass
class DeviceE2eSupervision:
    """Batched packed cyclic numerator graphs [B, S, K].  Index tensors are
    int64 (the dtype torch's gathers take); the JAX package keeps int32 —
    the values are identical."""

    in_src: torch.Tensor  # int64 [B, S, K], -1 = pad
    in_pdf: torch.Tensor  # int64 [B, S, K]
    in_logw: torch.Tensor  # float32 [B, S, K]
    final_logw: torch.Tensor  # float32 [B, S]
    weight: torch.Tensor  # float32 [B]
    #: per-sequence pdf vocabulary
    vocab: torch.Tensor  # int64 [B, Pv]
    pdf_local: torch.Tensor  # int64 [B, S, K] (indices into vocab)
    num_frames: int
    max_states: int
    max_arcs: int
    num_pdfs: int
    #: optional per-frame derivative weights [B, T] (deriv_weights
    #: semantics; applied by the chain loss's backward, not here)
    frame_weights: torch.Tensor | None = None
    #: optional tables as K8f/K8b read them
    #: (`num_resident.e2e_kernel_tables`); filled by `with_kernel_tables()`
    kernel_pre: tuple | None = None

    def to(self, device) -> "DeviceE2eSupervision":
        moved = _to_device(self, device)
        if self.kernel_pre is not None:
            moved.kernel_pre = tuple(x.to(device) for x in self.kernel_pre)
        return moved

    def with_kernel_tables(self, L_cap: int | None = None) -> "DeviceE2eSupervision":
        """A copy that also carries the tables in the kernels' types and the
        by-source order of each sequence's arcs, prepared once when the
        batch is placed so that a replayed batch pays nothing per step.
        `L_cap` fixes the lists' width for a run (`e2e_kernel_tables`)."""
        return dataclasses.replace(
            self, kernel_pre=num_resident.e2e_kernel_tables(self.in_src, self.in_logw, L_cap)
        )

    @staticmethod
    def from_host(s: E2eSupervision, device="cuda",
                  vocab_cap: int | None = None) -> "DeviceE2eSupervision":
        """From a batched (pad_and_stack_e2e) or single supervision; a
        single one gets a leading batch dim of 1.  The vocabulary's width
        is `vocab_cap` where given (a run's one width: `E2eChainDataset.
        estimate_e2e_caps`; a sequence that needs more raises), else the
        batch's own."""
        in_src = s.in_src if s.in_src.ndim == 3 else s.in_src[None]
        in_pdf = s.in_pdf if s.in_pdf.ndim == 3 else s.in_pdf[None]
        in_logw = s.in_logw if s.in_logw.ndim == 3 else s.in_logw[None]
        final = s.final_logw if s.final_logw.ndim == 2 else s.final_logw[None]
        B = in_src.shape[0]
        vocab, pdf_local = _seq_vocab_tables(np.asarray(in_src), np.asarray(in_pdf),
                                             pad_to=vocab_cap)

        def t(a, dtype):
            return torch.as_tensor(np.ascontiguousarray(a)).to(device=device, dtype=dtype)

        return DeviceE2eSupervision(
            in_src=t(in_src, torch.int64),
            in_pdf=t(in_pdf, torch.int64),
            in_logw=t(in_logw, torch.float32),
            final_logw=t(final, torch.float32),
            weight=torch.broadcast_to(
                torch.as_tensor(s.weight, dtype=torch.float32), (B,)
            ).contiguous().to(device),
            vocab=t(vocab, torch.int64),
            pdf_local=t(pdf_local, torch.int64),
            num_frames=int(s.num_frames),
            max_states=int(s.max_states),
            max_arcs=int(s.max_arcs),
            num_pdfs=int(s.num_pdfs),
            frame_weights=(
                None if s.frame_weights is None else t(s.frame_weights, torch.float32)
            ),
        )


def _arc_emissions(y: torch.Tensor, sup: DeviceE2eSupervision) -> torch.Tensor:
    """y [B, T, P] -> per-arc emission log-probs ylocal [B, T, S, K] f32
    (pad arcs read vocabulary slot 0; the recursions mask them)."""
    B, T, _ = y.shape
    S, K = sup.in_src.shape[1:]
    ysmall = torch.gather(y.float(), 2, sup.vocab[:, None, :].expand(B, T, -1))
    index = sup.pdf_local.reshape(B, 1, S * K).expand(B, T, S * K)
    return torch.gather(ysmall, 2, index).view(B, T, S, K)


def e2e_forward(
    y: torch.Tensor,  # [B, T, P]
    sup: DeviceE2eSupervision,
    ylocal: torch.Tensor | None = None,  # [B, T, S, K] to share with backward
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (log_prob [B], alphas [T+1, B, S])."""
    B, S = y.shape[0], sup.max_states
    if ylocal is None:
        ylocal = _arc_emissions(y, sup)
    a0 = torch.full((B, S), NEG_INF, device=y.device)
    a0[:, 0] = 0.0
    rest = num_resident.e2e_forward_resident(
        ylocal, sup.in_src, sup.in_logw, pre=sup.kernel_pre
    )
    alphas = torch.cat([a0[None], rest])
    log_p = torch.logsumexp(alphas[-1] + sup.final_logw, dim=-1)
    return log_p, alphas


def e2e_backward(
    y: torch.Tensor,
    sup: DeviceE2eSupervision,
    log_p: torch.Tensor,
    alphas: torch.Tensor,
    ylocal: torch.Tensor | None = None,  # [B, T, S, K] shared with forward
) -> torch.Tensor:
    """Returns gamma [B, T, P] = d(log_prob)/dy; zero for sequences whose
    log_prob is not finite."""
    B, T, P = y.shape
    if ylocal is None:
        ylocal = _arc_emissions(y, sup)
    post = num_resident.e2e_backward_resident(
        ylocal, alphas[:-1], sup.in_src, sup.in_logw, sup.final_logw, log_p,
        pre=sup.kernel_pre,
    )  # [B, T, S, K], exactly 0 on pad arcs
    # to vocabulary space, then to pdf space.  Pad vocabulary slots repeat
    # pdf 0 but no arc refers to them, so they carry exactly 0 and the
    # scatter's order does not matter
    Pv = sup.vocab.shape[-1]
    gamma_small = arcs_to_vocab(post, sup.pdf_local, Pv)
    vocab = sup.vocab[:, None, :].expand(B, T, Pv)
    return post.new_zeros((B, T, P)).scatter_add_(2, vocab, gamma_small)


def arcs_to_vocab(post: torch.Tensor, pdf_local: torch.Tensor, Pv: int) -> torch.Tensor:
    """Arc posteriors post [B, T, S, K] summed into each sequence's
    vocabulary slots (pdf_local [B, S, K]): [B, T, Pv].  A product with each
    arc's one-hot slot, float32 with TF32 off: one sum order, run after run
    (a pad arc's zero posterior adds 0)."""
    B, T, S, K = post.shape
    onehot = post.new_zeros((B, S * K, Pv)).scatter_(2, pdf_local.reshape(B, S * K, 1), 1.0)
    with full_float32():
        return torch.bmm(post.view(B, T, S * K), onehot)
