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
[B, K*S] x [K*S, S] product backward, with a V that is more than 99.8%
zeros at the shipped graphs.

On a CUDA tensor each pass is one launch of csrc/den_resident.cu, which
walks V's compressed forms (one block per sequence, all frames inside the
block); on a CPU tensor the plain PyTorch version beside it runs the same
recursion with the dense V.  There is no other fallback.
"""

from __future__ import annotations

import dataclasses
import math
import typing

import numpy as np
import torch

from torchain_tpu_torch import kernels
from torchain_tpu_torch.graphs.den_graph import DenGraph

#: threads of a K1/K2 (and K9f/K9b) block, a constant of csrc/den_common.cuh
#: (`THREADS`) mirrored here for the emulation of the kernels' block sums,
#: which run over the per-thread shares in this grouping
THREADS = 1024

#: indices of the compressed forms are 16-bit (stored as int16, read as
#: unsigned) below this many states and slots
INDEX16_LIMIT = 65536

#: the dynamic shared memory a block may ask for on the H100 (its opt-in
#: limit, what `den_shared_limit` reports there): the CPU holds the resident
#: form to it (ops/device_graphs.py `auto_den_graph`), so that the CPU takes
#: the form the card takes
H100_SHARED_LIMIT = 232_448


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def carried_bytes(backward: int, S: int, K: int, P: int) -> int:
    """The shared memory a K1 (backward=0) or K2 (1) block carries for one
    sequence, without the graph's tables: a host copy of
    csrc/den_resident.cu `den_shared_bytes(backward, S, K, P, 0, 0, 0)`
    (K1: sigma [S], alpha [K*S], two p rows [P]; K2: bh [S], two ah rows,
    one p row; each 16-byte aligned; two reduction arrays of a float a
    warp)."""
    up16 = lambda n: (n + 15) // 16 * 16  # noqa: E731
    rows, prows = (2, 1) if backward else (1, 2)
    return up16(4 * S) + rows * up16(4 * K * S) + prows * up16(4 * P) + 2 * 4 * (THREADS // 32)


def compress(V: np.ndarray, index_dtype) -> tuple[np.ndarray, ...]:
    """V's non-zeros by slot (CSC: column offsets, row indices, values;
    each column's entries in row order) and by state (CSR: row offsets,
    column indices, values; each row's entries in column order).  Offsets
    int32, indices `index_dtype` (int16 holds them as unsigned bits),
    values float32."""
    rows, cols = np.nonzero(V)  # row-major: sorted by row, then column
    by_col = np.lexsort((rows, cols))
    S, KS = V.shape
    csr_off = np.concatenate([[0], np.cumsum(np.bincount(rows, minlength=S))]).astype(np.int32)
    csc_off = np.concatenate([[0], np.cumsum(np.bincount(cols, minlength=KS))]).astype(np.int32)

    def idx(a):
        return a.astype(np.uint16).view(np.int16) if index_dtype == np.int16 else a.astype(np.int32)

    return (
        csc_off, idx(rows[by_col]), V[rows[by_col], cols[by_col]].astype(np.float32),
        csr_off, idx(cols), V[rows, cols].astype(np.float32),
    )


@dataclasses.dataclass
class DeviceResidentDenGraph:
    """Slot-dense denominator graph (float32).  Padding slots/states have
    zero V columns; dead slots have slot_pdf -1.

    Beside the dense V (which the plain versions multiply) the graph holds
    V's non-zeros twice, built once on the host: by slot (CSC, what K1's
    h = sigma @ V walks) and by state (CSR, what K2's v = V @ w walks).
    Entries are sorted by index within each column and each row, so the
    kernels' sum order follows from the graph alone.  Indices are 16-bit
    (int16 tensors holding unsigned values) where S_pad and K*S_pad are below
    65,536, which every graph the kernels can hold meets (K1 keeps K*S_pad
    floats in shared memory) and both shipped graphs do (4352 and 7936
    slots); int32 otherwise, for the plain versions alone."""

    V: torch.Tensor  # f32 [S_pad, K*S_pad] transition probs
    slot_pdf: torch.Tensor  # int32 [K*S_pad] pdf per live slot, -1 if dead
    init: torch.Tensor  # f32 [S_pad] initial probs (stationary + boost)
    #: CSR of the live slots of each pdf: pdf_slots[pdf_offsets[q] :
    #: pdf_offsets[q+1]] are the slots emitting pdf q, in slot order (the
    #: backward kernel sums occupancies over them without atomics)
    pdf_offsets: torch.Tensor  # int32 [P + 1]
    pdf_slots: torch.Tensor  # int32 [live slots]
    csc_offsets: torch.Tensor  # int32 [K*S_pad + 1]
    csc_rows: torch.Tensor  # int16 (unsigned) [nnz] state of each entry
    csc_vals: torch.Tensor  # f32 [nnz]
    csr_offsets: torch.Tensor  # int32 [S_pad + 1]
    csr_cols: torch.Tensor  # int16 (unsigned) [nnz] slot of each entry
    csr_vals: torch.Tensor  # f32 [nnz]
    num_states: int  # S_pad
    real_states: int
    num_slots: int  # K
    num_pdfs: int

    @property
    def nnz(self) -> int:
        return int(self.csc_vals.shape[0])

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
    def from_dense(
        V: np.ndarray, slot_pdf: np.ndarray, init: np.ndarray, num_pdfs: int,
        real_states: int, device="cuda",
    ) -> "DeviceResidentDenGraph":
        """The graph of a slot-dense V [S_pad, K*S_pad] (f32), its slot_pdf
        [K*S_pad] (-1 = dead) and init [S_pad]: builds the pdf CSR and V's
        compressed forms.  A dead slot's V column must be zero."""
        S, KS = V.shape
        if KS % S:
            raise ValueError(f"V {V.shape}: the slots are not a multiple of the states")
        if V[:, slot_pdf < 0].any():
            raise ValueError("V has transitions into a dead slot (slot_pdf -1)")
        live = np.flatnonzero(slot_pdf >= 0)
        order = live[np.argsort(slot_pdf[live], kind="stable")]
        counts = np.bincount(slot_pdf[live], minlength=num_pdfs)
        offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
        index = np.int16 if KS < INDEX16_LIMIT else np.int32
        csc_off, csc_rows, csc_vals, csr_off, csr_cols, csr_vals = compress(V, index)
        t = lambda a: torch.as_tensor(a).to(device)  # noqa: E731
        return DeviceResidentDenGraph(
            V=t(V),
            slot_pdf=t(slot_pdf.astype(np.int32)),
            init=t(init.astype(np.float32)),
            pdf_offsets=t(offsets),
            pdf_slots=t(order.astype(np.int32)),
            csc_offsets=t(csc_off),
            csc_rows=t(csc_rows),
            csc_vals=t(csc_vals),
            csr_offsets=t(csr_off),
            csr_cols=t(csr_cols),
            csr_vals=t(csr_vals),
            num_states=S,
            real_states=real_states,
            num_slots=KS // S,
            num_pdfs=int(num_pdfs),
        )

    @staticmethod
    def from_host(
        g: DenGraph, pad_to: int = 128, max_slots: int = 2, device="cuda"
    ) -> "DeviceResidentDenGraph":
        return DeviceResidentDenGraph._from_layout(
            g, slot_layout(g, max_slots), pad_to, device
        )

    @staticmethod
    def _from_layout(
        g: DenGraph, layout: "SlotLayout", pad_to: int, device
    ) -> "DeviceResidentDenGraph":
        """`from_host` on the slot layout `slot_layout` gave for `g`."""
        inv, uniq_pdf, uniq_slot, uniq_state, extra, clone_base, K, S_tot = layout
        S = g.num_states
        src = g.in_src.astype(np.int64)
        prob = np.exp(g.in_logw.astype(np.float64)).astype(np.float32)
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

        init = np.zeros(S_pad, dtype=np.float32)
        init[:S] = g.initial_probs
        return DeviceResidentDenGraph.from_dense(
            V, slot_pdf, init, int(g.num_pdfs), S, device=device
        )


class SlotLayout(typing.NamedTuple):
    """Where each distinct (dst, pdf) pair of a graph's arcs goes in the
    slot layout, before padding (`slot_layout`)."""

    inv: np.ndarray  # each arc's pair
    uniq_pdf: np.ndarray  # each pair's pdf,
    uniq_slot: np.ndarray  # slot
    uniq_state: np.ndarray  # and state
    extra: np.ndarray  # the extra clones of each state
    clone_base: np.ndarray  # where they start
    K: int
    S_tot: int  # the states with clones

    def sizes(self, pad_to: int) -> tuple[int, int]:
        """(S_pad, K) of the slot-dense graph built on this layout."""
        return _round_up(self.S_tot, pad_to), self.K


def slot_layout(g: DenGraph, max_slots: int = 2) -> SlotLayout:
    """The slot layout of `g`: the k-th distinct (dst, pdf) pair of a state
    takes slot k; a state entered through more than `max_slots` distinct
    pdfs is SPLIT into clones sharing the original's out-arc row (forward
    dynamics unchanged: alpha mass just distributes across the clones),
    numbered after the real states; only clone 0 carries the initial
    probability.  Its sizes need no V (an S_pad x K*S_pad float32 matrix),
    and `len(uniq_pdf)` is the count of distinct pairs, the expanded states
    of the dense Moore form."""
    S = g.num_states
    dst = np.repeat(np.arange(S, dtype=np.int64), np.diff(g.in_offsets))
    key = dst * (g.num_pdfs + 1) + g.in_pdf.astype(np.int64)
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
    uniq_state = np.where(clone_rank == 0, uniq_dst, clone_base[uniq_dst] + clone_rank - 1)
    return SlotLayout(inv, uniq_pdf, uniq_slot, uniq_state, extra, clone_base, K, S_tot)


def slot_sizes(g: DenGraph, pad_to: int = 128, max_slots: int = 2) -> tuple[int, int]:
    """(S_pad, K) of the slot-dense graph `from_host` would build from `g`,
    without building its V."""
    return slot_layout(g, max_slots).sizes(pad_to)


# ---------------------------------------------------------------------------
# The kernels' shared memory
# ---------------------------------------------------------------------------

#: (device, direction, sizes) -> (bytes, staged), asked of the library once
_PLANS: dict[tuple, tuple[int, int]] = {}


def shared_plan(g: DeviceResidentDenGraph, backward: int, device) -> tuple[int, int]:
    """Bytes of shared memory a K1 (backward=0) or K2 (1) block asks for,
    and whether V's compressed form and the slot tables are staged there
    (1) or read through L2 (0): staged wherever they fit beside the carried
    state under the device's opt-in limit.  At the shipped graphs (H100
    limit 232,448 bytes) both are staged:

        graph       K1 carried + tables = bytes     K2 carried + tables = bytes
        trigram     27,008 + 100,384 = 127,392      44,096 + 100,336 = 144,432
        production  61,312 + 129,664 = 190,976      86,336 + 135,952 = 222,288

    (K1 carries sigma [S], alpha [K*S] and two p rows [P]; K2 bh [S], two ah
    rows [K*S] and one p row.  The tables: V's compressed form for the
    kernel's direction and slot_pdf as 16 bits; K2 also the pdf CSR.)  Raises ValueError where the
    carried state alone exceeds the limit."""
    S, K, P = g.num_states, g.num_slots, g.num_pdfs
    live = int(g.pdf_slots.shape[0])
    key = (device.index, backward, S, K, P, g.nnz, live)
    plan = _PLANS.get(key)
    if plan is None:
        need = kernels.entry("den_resident", "den_shared_bytes")
        limit = kernels.entry("den_resident", "den_shared_limit")()
        carried = need(backward, S, K, P, g.nnz, live, 0)
        if carried > limit:
            what = "den_backward" if backward else "den_forward"
            raise ValueError(
                f"{what}: the carried state of a sequence (S_pad={S}, K={K}, P={P}) needs"
                f" {carried} bytes of shared memory, more than the {limit} a block may have"
            )
        staged = need(backward, S, K, P, g.nnz, live, 1)
        plan = _PLANS[key] = (staged, 1) if staged <= limit else (carried, 0)
    return plan


def _check_graph(g: DeviceResidentDenGraph, backward: bool) -> None:
    S, KS, P = g.num_states, g.num_states * g.num_slots, g.num_pdfs
    nnz = g.nnz
    kernels.check_tensor("init", g.init, torch.float32, (S,))
    kernels.check_tensor("slot_pdf", g.slot_pdf, torch.int32, (KS,))
    if backward:
        kernels.check_tensor("csr_offsets", g.csr_offsets, torch.int32, (S + 1,))
        kernels.check_tensor("csr_cols", g.csr_cols, torch.int16, (nnz,))
        kernels.check_tensor("csr_vals", g.csr_vals, torch.float32, (nnz,))
        kernels.check_tensor("pdf_offsets", g.pdf_offsets, torch.int32, (P + 1,))
        kernels.check_tensor("pdf_slots", g.pdf_slots, torch.int32)
    else:
        kernels.check_tensor("csc_offsets", g.csc_offsets, torch.int32, (KS + 1,))
        kernels.check_tensor("csc_rows", g.csc_rows, torch.int16, (nnz,))
        kernels.check_tensor("csc_vals", g.csc_vals, torch.float32, (nnz,))


# ---------------------------------------------------------------------------
# K1: forward.  Kernel wrapper and its plain version (same signature).
# ---------------------------------------------------------------------------


def _emissions(p_t: torch.Tensor, slot_pdf: torch.Tensor) -> torch.Tensor:
    """pe [B, KS] = p_t[:, slot_pdf], exactly 0 on dead slots."""
    pe = p_t[:, slot_pdf.clamp(min=0).long()]
    return torch.where(slot_pdf >= 0, pe, torch.zeros((), dtype=pe.dtype))


def den_forward_plain(p, g: DeviceResidentDenGraph, leaky: float):
    """Plain PyTorch K1.  p [T, B, P] = exp(y - ymax) -> (logc [T, B],
    ah [T, B, KS] normalized per-slot alphas).  Multiplies the dense V."""
    T, B, _ = p.shape
    V, init = g.V, g.init
    S, KS = V.shape
    K = KS // S
    sh = init.expand(B, S)
    logc = p.new_empty((T, B))
    ah = p.new_empty((T, B, KS))
    for t in range(T):
        sig = sh + leaky * sh.sum(-1, keepdim=True) * init if leaky > 0.0 else sh
        alpha = (sig @ V) * _emissions(p[t], g.slot_pdf)
        c = alpha.sum(-1, keepdim=True)
        logc[t] = torch.log(c[:, 0])
        ah[t] = alpha / c
        sh = ah[t].view(B, K, S).sum(1)
    return logc, ah


def den_forward_kernel(p, g: DeviceResidentDenGraph, leaky: float):
    """K1.  Same contract as den_forward_plain; one launch of
    csrc/den_resident.cu:den_forward on a CUDA tensor."""
    if p.device.type == "cpu":
        return den_forward_plain(p, g, leaky)
    T, B, P = p.shape
    S, K = g.num_states, g.num_slots
    kernels.check_tensor("p", p, torch.float32, (T, B, g.num_pdfs))
    _, staged = shared_plan(g, 0, p.device)  # first: a graph too large raises here
    _check_graph(g, backward=False)
    ah = torch.empty((T, B, K * S), device=p.device, dtype=torch.float32)
    logc = torch.empty((T, B), device=p.device, dtype=torch.float32)
    err = kernels.entry("den_resident", "den_forward")(
        p.data_ptr(), g.init.data_ptr(), g.csc_offsets.data_ptr(), g.csc_rows.data_ptr(),
        g.csc_vals.data_ptr(), g.slot_pdf.data_ptr(), ah.data_ptr(), logc.data_ptr(),
        T, B, P, S, K, g.nnz, staged, float(leaky), kernels.stream_of(p.device),
    )
    if err:
        kernels.check(kernels.library("den_resident"), err, "den_forward")
    den_forward_kernel.launches += 1
    return logc, ah


den_forward_kernel.launches = 0


# ---------------------------------------------------------------------------
# K2: backward.
# ---------------------------------------------------------------------------


def den_backward_plain(p, ah, F, ymax, log_z, g: DeviceResidentDenGraph, leaky: float):
    """Plain PyTorch K2.  p [T, B, P], ah [T, B, KS], F and ymax [T, B],
    log_z [B] -> gamma [B, T, P] pdf occupancies.  Multiplies the dense V^T
    and sums the occupancies by pdf with index_add_."""
    T, B, P = p.shape
    V, init, slot_pdf = g.V, g.init, g.slot_pdf
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


def den_backward_kernel(p, ah, F, ymax, log_z, g: DeviceResidentDenGraph, leaky: float):
    """K2.  Same contract as den_backward_plain; one launch of
    csrc/den_resident.cu:den_backward on a CUDA tensor."""
    if p.device.type == "cpu":
        return den_backward_plain(p, ah, F, ymax, log_z, g, leaky)
    T, B, P = p.shape
    S, K = g.num_states, g.num_slots
    kernels.check_tensor("p", p, torch.float32, (T, B, g.num_pdfs))
    kernels.check_tensor("ah", ah, torch.float32, (T, B, K * S))
    kernels.check_tensor("F", F, torch.float32, (T, B))
    kernels.check_tensor("ymax", ymax, torch.float32, (T, B))
    kernels.check_tensor("log_z", log_z, torch.float32, (B,))
    _, staged = shared_plan(g, 1, p.device)
    _check_graph(g, backward=True)
    gamma = torch.empty((B, T, P), device=p.device, dtype=torch.float32)
    # G's start rounded to float32 as the plain version's new_full rounds it
    g0 = math.log1p(leaky) if leaky > 0.0 else 0.0
    err = kernels.entry("den_resident", "den_backward")(
        p.data_ptr(), ah.data_ptr(), F.data_ptr(), ymax.data_ptr(), log_z.data_ptr(),
        g.init.data_ptr(), g.csr_offsets.data_ptr(), g.csr_cols.data_ptr(),
        g.csr_vals.data_ptr(), g.pdf_offsets.data_ptr(), g.pdf_slots.data_ptr(),
        g.slot_pdf.data_ptr(), gamma.data_ptr(),
        T, B, P, S, K, g.nnz, int(g.pdf_slots.shape[0]), staged,
        float(leaky), g0, kernels.stream_of(p.device),
    )
    if err:
        kernels.check(kernels.library("den_resident"), err, "den_backward")
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
    logc, ah = den_forward_kernel(p, g, leaky)
    log_z = logc.sum(0) + ymax_t.sum(0)
    if leaky > 0.0:
        log_z = log_z + math.log1p(leaky)
    res = dict(p=p, ymax=ymax_t.contiguous(), logc=logc, ah=ah, log_z=log_z)
    return log_z, res


def den_backward(g: DeviceResidentDenGraph, res: dict, leaky: float = 0.0):
    """Returns gamma [B, T, P]; scale bookkeeping identical to den_forward."""
    F = torch.cumsum(res["logc"] + res["ymax"], 0).contiguous()  # [T, B]
    return den_backward_kernel(
        res["p"], res["ah"], F, res["ymax"], res["log_z"].contiguous(), g, leaky
    )
