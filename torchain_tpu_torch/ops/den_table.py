"""Denominator forward-backward over padded in-arc TABLES, log semiring.

Behavioral reference: kaldi/src/chain/chain-denominator.cc
(`DenominatorComputation::Forward/Backward`).  Port of
torchain_tpu/ops/den_table.py: chain denominator graphs have small
in-degrees, so padding each state's in-arc list to a fixed K_in gives dense
[S, K_in] tables, and each frame becomes two constant-index gathers and a
masked logsumexp over K_in, with the leaky HMM and all-states-final
semantics of ops/den_scan.py.  The backward pulls beta back over out-arc
tables [S, K_out] (a gather over destinations, a logsumexp over out-arcs);
its only scatter is the per-frame occupancy sum into the pdf bins, over the
real arcs alone.  The widths are the graph's largest degrees: one state
of high in-degree (3,134 in a triphone graph of mean 3.9) makes every
[B, S, K] temporary that wide.

The same contract as ops/den_scan.py (the forward returns the alphas for
the backward).  Plain PyTorch with one loop iteration per frame, as the
JAX package's form is plain XLA; its per-op temporary is [B, S, K]
(against the scan's [A, B]).  It is an explicit form: `auto_den_graph`
never picks it, in the port as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from torchain_tpu_torch.graphs.den_graph import DenGraph
from torchain_tpu_torch.ops.den_scan import NEG_INF, _leak


@dataclasses.dataclass
class DeviceDenTableGraph:
    """Padded in/out-arc tables of the denominator HMM (shared across the
    batch).  -1 src/dst marks padding (weight -inf).  Index tensors are
    int64 (the dtype torch's indexing takes)."""

    in_src: torch.Tensor  # int64 [S, K_in]
    in_pdf: torch.Tensor  # int64 [S, K_in]
    in_logw: torch.Tensor  # float32 [S, K_in]
    out_dst: torch.Tensor  # int64 [S, K_out]
    out_pdf: torch.Tensor  # int64 [S, K_out]
    out_logw: torch.Tensor  # float32 [S, K_out]
    log_init: torch.Tensor  # float32 [S]
    num_states: int
    num_pdfs: int
    max_in: int
    max_out: int

    def to(self, device) -> "DeviceDenTableGraph":
        return dataclasses.replace(
            self,
            **{
                f.name: getattr(self, f.name).to(device)
                for f in dataclasses.fields(self)
                if isinstance(getattr(self, f.name), torch.Tensor)
            },
        )

    @staticmethod
    def from_host(g: DenGraph, pad_multiple: int = 1, device="cuda") -> "DeviceDenTableGraph":
        S = g.num_states

        def pack(offsets, a_idx, a_pdf, a_logw):
            deg = np.diff(offsets)
            K = max(int(deg.max()) if S else 0, 1)
            K = ((K + pad_multiple - 1) // pad_multiple) * pad_multiple
            rows = np.repeat(np.arange(S), deg)
            cols = np.arange(len(rows)) - np.repeat(offsets[:-1], deg)
            idx = np.full((S, K), -1, dtype=np.int64)
            pdf = np.zeros((S, K), dtype=np.int64)
            logw = np.full((S, K), -np.inf, dtype=np.float32)
            idx[rows, cols] = a_idx
            pdf[rows, cols] = a_pdf
            logw[rows, cols] = a_logw
            return idx, pdf, logw, K

        in_src, in_pdf, in_logw, K_in = pack(g.in_offsets, g.in_src, g.in_pdf, g.in_logw)
        out_dst, out_pdf, out_logw, K_out = pack(g.out_offsets, g.out_dst, g.out_pdf, g.out_logw)
        with np.errstate(divide="ignore"):
            log_init = np.log(g.initial_probs.astype(np.float64)).astype(np.float32)
        t = lambda a: torch.as_tensor(a).to(device)  # noqa: E731
        return DeviceDenTableGraph(
            in_src=t(in_src), in_pdf=t(in_pdf), in_logw=t(in_logw),
            out_dst=t(out_dst), out_pdf=t(out_pdf), out_logw=t(out_logw),
            log_init=t(log_init), num_states=S, num_pdfs=int(g.num_pdfs),
            max_in=K_in, max_out=K_out,
        )


def den_forward(
    y: torch.Tensor,  # [B, T, P]
    g: DeviceDenTableGraph,
    leaky: float = 0.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (log_z [B], alphas [T+1, B, S]), post-leak: the contract of
    ops/den_scan.py."""
    y = y.detach().float()
    B, T, _ = y.shape
    mask = g.in_src >= 0  # [S, K]
    src = g.in_src.clamp(min=0)
    alpha = _leak(g.log_init.expand(B, g.num_states), g.log_init, leaky)
    alphas = [alpha]
    for t in range(T):
        vals = torch.where(mask, alpha[:, src] + g.in_logw + y[:, t][:, g.in_pdf], NEG_INF)
        alpha = _leak(torch.logsumexp(vals, dim=-1), g.log_init, leaky)
        alphas.append(alpha)
    return torch.logsumexp(alpha, dim=-1), torch.stack(alphas)


def den_backward(
    y: torch.Tensor,  # [B, T, P]
    g: DeviceDenTableGraph,
    log_z: torch.Tensor,  # [B]
    alphas: torch.Tensor,  # [T+1, B, S]
    leaky: float = 0.0,
) -> torch.Tensor:
    """Returns gamma [B, T, P] = d(log Z)/dy."""
    y = y.detach().float()
    B, T, P = y.shape
    out_mask = g.out_dst >= 0  # [S, K2]
    dst = g.out_dst.clamp(min=0)
    # the real out-arcs' slots of the [S * K2] table, and each one's bin in
    # the flattened [B, P] occupancies: only they are scattered (the padding,
    # all at pdf 0, adds exactly 0, and on the card its atomic adds into one
    # bin a sequence take the whole step at a triphone graph's K2)
    live = torch.nonzero(out_mask.reshape(-1)).squeeze(1)
    bins = (torch.arange(B, device=y.device)[:, None] * P + g.out_pdf.reshape(-1)[live]).reshape(-1)
    b = y.new_zeros((B, g.num_states))  # dZ/dalpha'_t
    gamma = y.new_empty((B, T, P))
    for t in range(T - 1, -1, -1):
        if leaky > 0.0:
            tot = torch.logsumexp(g.log_init + b, dim=-1, keepdim=True)
            b = torch.logaddexp(b, math.log(leaky) + tot)
        # out-arc view: for source s, its arcs (dst, pdf, w)
        arc_w = torch.where(out_mask, g.out_logw + y[:, t][:, g.out_pdf] + b[:, dst], NEG_INF)
        post = torch.exp(alphas[t][:, :, None] + arc_w - log_z[:, None, None])
        gamma[:, t] = y.new_zeros(B * P).index_add_(
            0, bins, post.reshape(B, -1)[:, live].reshape(-1)).view(B, P)
        b = torch.logsumexp(arc_w, dim=-1)  # [B, S] = dZ/dalpha'_{t-1}
    return gamma
