"""Denominator forward-backward on the slot-dense graph, with kernels K1
(forward) and K2 (backward).

Behavioral reference: kaldi/src/chain/chain-denominator.{h,cc} (probability
space, per-frame "arbitrary scale" renormalization, leaky HMM).  Port of
torchain_tpu/ops/den_resident.py: the same slot layout and the same scale
bookkeeping, so `log_z` and the occupancies agree with the JAX package.

Slot layout: expanded state e = k * S_pad + s; slot (k, s) receives all
arcs into state s whose emission pdf is the k-th distinct in-pdf of s
(K = 2 for the chain topology; states entered through more distinct pdfs
are split into clones sharing the original's out-arc row).  Per frame the
recursion is one [B, S] x [S, K*S] product forward and one
[B, K*S] x [K*S, S] product backward.

On a CUDA tensor each pass is one call into csrc/den_resident.cu (the
hand-written kernels); on a CPU tensor the plain PyTorch version beside it
runs the same arithmetic.  There is no other fallback.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from torchain_tpu_torch import kernels
from torchain_tpu_torch.graphs.den_graph import DenGraph


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass
class DeviceResidentDenGraph:
    """Slot-dense denominator graph (float32).  Padding slots/states have
    zero V columns; dead slots have slot_pdf -1."""

    V: torch.Tensor  # f32 [S_pad, K*S_pad] transition probs
    slot_pdf: torch.Tensor  # int32 [K*S_pad] pdf per live slot, -1 if dead
    init: torch.Tensor  # f32 [S_pad] initial probs (stationary + boost)
    #: CSR of the live slots of each pdf: pdf_slots[pdf_offsets[q] :
    #: pdf_offsets[q+1]] are the slots emitting pdf q (the backward kernel
    #: sums occupancies over them without atomics)
    pdf_offsets: torch.Tensor  # int32 [P + 1]
    pdf_slots: torch.Tensor  # int32 [live slots]
    num_states: int  # S_pad
    real_states: int
    num_slots: int  # K
    num_pdfs: int

    def to(self, device) -> "DeviceResidentDenGraph":
        return dataclasses.replace(
            self,
            **{
                f.name: getattr(self, f.name).to(device)
                for f in dataclasses.fields(self)
                if isinstance(getattr(self, f.name), torch.Tensor)
            },
        )

    @staticmethod
    def from_host(
        g: DenGraph, pad_to: int = 128, max_slots: int = 2, device="cuda"
    ) -> "DeviceResidentDenGraph":
        S = g.num_states
        dst = np.repeat(np.arange(S, dtype=np.int64), np.diff(g.in_offsets))
        pdf = g.in_pdf.astype(np.int64)
        src = g.in_src.astype(np.int64)
        prob = np.exp(g.in_logw.astype(np.float64)).astype(np.float32)
        # k-th distinct (dst, pdf) pair per dst; states entered through more
        # than max_slots distinct pdfs are SPLIT into clones sharing the
        # original's out-arc row (forward dynamics unchanged: alpha mass
        # just distributes across the clones); only clone 0 carries the
        # initial probability
        key = dst * (g.num_pdfs + 1) + pdf
        uniq_keys, inv = np.unique(key, return_inverse=True)
        uniq_dst = (uniq_keys // (g.num_pdfs + 1)).astype(np.int64)
        uniq_pdf = (uniq_keys % (g.num_pdfs + 1)).astype(np.int32)
        first_of_dst = np.searchsorted(uniq_dst, np.arange(S))
        slot_of_uniq = np.arange(uniq_keys.shape[0]) - first_of_dst[uniq_dst]
        K = min(int(slot_of_uniq.max()) + 1 if uniq_keys.size else 1, max_slots)

        clone_rank = slot_of_uniq // K
        uniq_slot = (slot_of_uniq % K).astype(np.int64)
        n_clones_of = np.zeros(S, dtype=np.int64)
        np.maximum.at(n_clones_of, uniq_dst, clone_rank + 1)
        n_clones_of = np.maximum(n_clones_of, 1)
        extra = n_clones_of - 1
        clone_base = S + np.concatenate([[0], np.cumsum(extra)[:-1]])
        S_tot = S + int(extra.sum())
        uniq_state = np.where(
            clone_rank == 0, uniq_dst, clone_base[uniq_dst] + clone_rank - 1
        )

        S_pad = _round_up(S_tot, pad_to)
        KS = K * S_pad
        slot_pdf = np.full(KS, -1, dtype=np.int32)
        e_of_uniq = uniq_slot * S_pad + uniq_state
        slot_pdf[e_of_uniq] = uniq_pdf

        V = np.zeros((S_pad, KS), dtype=np.float32)
        np.add.at(V, (src, e_of_uniq[inv]), prob)
        for s in np.flatnonzero(extra):  # clones replicate the out-row
            for c in range(int(extra[s])):
                V[clone_base[s] + c] = V[s]

        live = np.flatnonzero(slot_pdf >= 0)
        order = live[np.argsort(slot_pdf[live], kind="stable")]
        counts = np.bincount(slot_pdf[live], minlength=g.num_pdfs)
        offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)

        init = np.zeros(S_pad, dtype=np.float32)
        init[:S] = g.initial_probs
        t = lambda a: torch.as_tensor(a).to(device)  # noqa: E731
        return DeviceResidentDenGraph(
            V=t(V),
            slot_pdf=t(slot_pdf),
            init=t(init),
            pdf_offsets=t(offsets),
            pdf_slots=t(order.astype(np.int32)),
            num_states=S_pad,
            real_states=S,
            num_slots=K,
            num_pdfs=int(g.num_pdfs),
        )


# ---------------------------------------------------------------------------
# K1: forward.  Kernel wrapper and its plain version (same signature).
# ---------------------------------------------------------------------------


def _emissions(p_t: torch.Tensor, slot_pdf: torch.Tensor) -> torch.Tensor:
    """pe [B, KS] = p_t[:, slot_pdf], exactly 0 on dead slots."""
    pe = p_t[:, slot_pdf.clamp(min=0).long()]
    return torch.where(slot_pdf >= 0, pe, torch.zeros((), dtype=pe.dtype))


def den_forward_plain(p, V, slot_pdf, init, leaky: float):
    """Plain PyTorch K1.  p [T, B, P] = exp(y - ymax) -> (logc [T, B],
    ah [T, B, KS] normalized per-slot alphas)."""
    T, B, _ = p.shape
    S, KS = V.shape
    K = KS // S
    sh = init.expand(B, S)
    logc = p.new_empty((T, B))
    ah = p.new_empty((T, B, KS))
    for t in range(T):
        sig = sh + leaky * sh.sum(-1, keepdim=True) * init if leaky > 0.0 else sh
        alpha = (sig @ V) * _emissions(p[t], slot_pdf)
        c = alpha.sum(-1, keepdim=True)
        logc[t] = torch.log(c[:, 0])
        ah[t] = alpha / c
        sh = ah[t].view(B, K, S).sum(1)
    return logc, ah


def den_forward_kernel(p, V, slot_pdf, init, leaky: float):
    """K1.  Same contract as den_forward_plain; launches
    csrc/den_resident.cu:den_forward on a CUDA tensor."""
    if p.device.type == "cpu":
        return den_forward_plain(p, V, slot_pdf, init, leaky)
    T, B, P = p.shape
    S, KS = V.shape
    K = KS // S
    kernels.check_tensor("p", p, torch.float32)
    kernels.check_tensor("V", V, torch.float32)
    kernels.check_tensor("slot_pdf", slot_pdf, torch.int32, (KS,))
    kernels.check_tensor("init", init, torch.float32, (S,))
    sigma0 = init * (1.0 + leaky * init.sum()) if leaky > 0.0 else init
    sigma = sigma0.expand(B, S).contiguous()
    ah = torch.empty((T, B, KS), device=p.device, dtype=torch.float32)
    logc = torch.empty((T, B), device=p.device, dtype=torch.float32)
    cpart = torch.empty((B, (KS + 63) // 64), device=p.device, dtype=torch.float32)
    lib = kernels.library("den_resident")
    err = lib.den_forward(
        p.data_ptr(), V.data_ptr(), slot_pdf.data_ptr(), init.data_ptr(),
        sigma.data_ptr(), ah.data_ptr(), cpart.data_ptr(), logc.data_ptr(),
        T, B, P, S, K, float(leaky), kernels.stream_of(p.device),
    )
    kernels.check(lib, err, "den_forward")
    den_forward_kernel.launches += 1
    return logc, ah


den_forward_kernel.launches = 0


# ---------------------------------------------------------------------------
# K2: backward.
# ---------------------------------------------------------------------------


def den_backward_plain(
    p, ah, F, ymax, log_z, V, slot_pdf, pdf_offsets, pdf_slots, init, leaky: float
):
    """Plain PyTorch K2.  p [T, B, P], ah [T, B, KS], F and ymax [T, B],
    log_z [B] -> gamma [B, T, P] pdf occupancies.  (pdf_offsets/pdf_slots
    are the kernel's CSR; the plain version sums with index_add_.)"""
    T, B, P = p.shape
    S, KS = V.shape
    K = KS // S
    live = slot_pdf >= 0
    live_pdf = slot_pdf[live].long()
    bh = p.new_ones((B, S))
    G = p.new_full((B,), math.log1p(leaky) if leaky > 0.0 else 0.0)
    gamma = p.new_zeros((B, T, P))
    for t in range(T - 1, -1, -1):
        bhe = bh.repeat(1, K)
        scale = torch.exp(F[t] + G - log_z)[:, None]
        occ = ah[t] * bhe * scale
        gamma[:, t].index_add_(1, live_pdf, occ[:, live])
        if t == 0:
            break  # the pullback past frame 0 feeds nothing
        v = (_emissions(p[t], slot_pdf) * bhe) @ V.T
        if leaky > 0.0:
            v = v + leaky * (v * init).sum(-1, keepdim=True)
        d = v.max(-1, keepdim=True).values
        d = torch.where(d > 0, d, torch.ones_like(d))
        bh = v / d
        G = G + ymax[t] + torch.log(d[:, 0])
    return gamma


#: split of the backward product's depth (K*S) into independent partial
#: sums, so its [B, S] output spreads over enough blocks to fill the card
BWD_SPLITS = 4


def den_backward_kernel(
    p, ah, F, ymax, log_z, V, slot_pdf, pdf_offsets, pdf_slots, init, leaky: float
):
    """K2.  Same contract as den_backward_plain; launches
    csrc/den_resident.cu:den_backward on a CUDA tensor."""
    if p.device.type == "cpu":
        return den_backward_plain(
            p, ah, F, ymax, log_z, V, slot_pdf, pdf_offsets, pdf_slots, init, leaky
        )
    T, B, P = p.shape
    S, KS = V.shape
    K = KS // S
    kernels.check_tensor("p", p, torch.float32)
    kernels.check_tensor("ah", ah, torch.float32, (T, B, KS))
    kernels.check_tensor("F", F, torch.float32, (T, B))
    kernels.check_tensor("ymax", ymax, torch.float32, (T, B))
    kernels.check_tensor("log_z", log_z, torch.float32, (B,))
    kernels.check_tensor("V", V, torch.float32)
    kernels.check_tensor("slot_pdf", slot_pdf, torch.int32, (KS,))
    kernels.check_tensor("pdf_offsets", pdf_offsets, torch.int32, (P + 1,))
    kernels.check_tensor("pdf_slots", pdf_slots, torch.int32)
    kernels.check_tensor("init", init, torch.float32, (S,))
    dev = p.device
    bh = torch.ones((B, S), device=dev, dtype=torch.float32)
    G = torch.full((B,), math.log1p(leaky) if leaky > 0.0 else 0.0, device=dev)
    vpart = torch.empty((BWD_SPLITS, B, S), device=dev, dtype=torch.float32)
    gamma = torch.empty((B, T, P), device=dev, dtype=torch.float32)
    lib = kernels.library("den_resident")
    err = lib.den_backward(
        p.data_ptr(), ah.data_ptr(), F.data_ptr(), ymax.data_ptr(),
        log_z.data_ptr(), V.data_ptr(), slot_pdf.data_ptr(),
        pdf_offsets.data_ptr(), pdf_slots.data_ptr(), init.data_ptr(),
        bh.data_ptr(), G.data_ptr(), vpart.data_ptr(), gamma.data_ptr(),
        T, B, P, S, K, BWD_SPLITS, float(leaky), kernels.stream_of(dev),
    )
    kernels.check(lib, err, "den_backward")
    den_backward_kernel.launches += 1
    return gamma


den_backward_kernel.launches = 0


# ---------------------------------------------------------------------------
# host-facing forward / backward (the JAX package's signatures)
# ---------------------------------------------------------------------------


def den_forward(y: torch.Tensor, g: DeviceResidentDenGraph, leaky: float = 0.0):
    """y [B, T, P] -> (log_z [B], residuals for den_backward)."""
    yt = y.detach().transpose(0, 1).float()  # [T, B, P]
    ymax_t = yt.max(-1).values  # [T, B]
    p = torch.exp(yt - ymax_t[..., None]).contiguous()
    logc, ah = den_forward_kernel(p, g.V, g.slot_pdf, g.init, leaky)
    log_z = logc.sum(0) + ymax_t.sum(0)
    if leaky > 0.0:
        log_z = log_z + math.log1p(leaky)
    res = dict(p=p, ymax=ymax_t.contiguous(), logc=logc, ah=ah, log_z=log_z)
    return log_z, res


def den_backward(g: DeviceResidentDenGraph, res: dict, leaky: float = 0.0):
    """Returns gamma [B, T, P]; scale bookkeeping identical to den_forward."""
    F = torch.cumsum(res["logc"] + res["ymax"], 0).contiguous()  # [T, B]
    return den_backward_kernel(
        res["p"], res["ah"], F, res["ymax"], res["log_z"].contiguous(),
        g.V, g.slot_pdf, g.pdf_offsets, g.pdf_slots, g.init, leaky,
    )
