"""Device-side (torch) containers for the packed graphs, and the choice of
denominator representation.

`DeviceDenGraph` and `DeviceDenseDenGraph` are the tensor twins of the
host-side `graphs.DenGraph` / `graphs.DenseDenGraph` (Kaldi's
DenominatorGraph arrays, kaldi/src/chain/chain-den-graph.h); the slot-dense
`DeviceResidentDenGraph` lives beside its kernels in ops/den_resident.py.
`DeviceSupervision` is the twin of `graphs.Supervision` (Kaldi's
NnetChainSupervision, kaldi/src/nnet3/nnet-chain-example.h), split at the
frame-0 / steady-state boundary exactly as the JAX package's is; the
flat-start `DeviceE2eSupervision` lives in ops/num_e2e.py."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from torchain_tpu_torch import kernels
from torchain_tpu_torch.graphs.debruijn import lifts_right_context, make_debruijn_den_graph
from torchain_tpu_torch.graphs.den_graph import DenGraph, DenseDenGraph, make_dense_den_graph
from torchain_tpu_torch.graphs.supervision import (  # noqa: F401 (re-exported)
    Supervision,
    _frame_vocab_tables,
    frame_vocab_width,
)
from torchain_tpu_torch.graphs.topology import ChainTopology
from torchain_tpu_torch.ops.den_debruijn import DeviceDeBruijnDenGraph
from torchain_tpu_torch.ops.den_resident import (
    H100_SHARED_LIMIT,
    INDEX16_LIMIT,
    DeviceResidentDenGraph,
    carried_bytes,
    compress,
    slot_layout,
)
from torchain_tpu_torch.ops.num_resident import kernel_tables


def _to_device(obj, device):
    """A copy of a dataclass of tensors with every tensor field on `device`."""
    return dataclasses.replace(
        obj,
        **{
            f.name: getattr(obj, f.name).to(device)
            for f in dataclasses.fields(obj)
            if isinstance(getattr(obj, f.name), torch.Tensor)
        },
    )


@dataclasses.dataclass
class DeviceDenGraph:
    """Sparse arc-list denominator graph for the log-semiring recursion of
    ops/den_scan.py: the arcs sorted by destination (alpha) and by source
    (beta).  Index tensors are int64 (the dtype torch's indexing takes)."""

    # view sorted by dst (forward: reduce over in-arcs)
    in_src: torch.Tensor  # int64 [A]
    in_pdf: torch.Tensor  # int64 [A]
    in_logw: torch.Tensor  # float32 [A]
    in_dst: torch.Tensor  # int64 [A] (sorted)
    # view sorted by src (backward: reduce over out-arcs)
    out_src: torch.Tensor  # int64 [A] (sorted)
    out_dst: torch.Tensor  # int64 [A]
    out_pdf: torch.Tensor  # int64 [A]
    out_logw: torch.Tensor  # float32 [A]
    log_init: torch.Tensor  # float32 [S]
    num_states: int
    num_pdfs: int
    #: store alpha every this many frames and recompute the rest in the
    #: backward (ops/den_scan.py `den_forward_checkpointed`), where T is a
    #: larger multiple of it; 0 stores every frame.  The JAX package's
    #: TORCHAIN_ALPHA_CHECKPOINT
    checkpoint_every: int = 0

    def to(self, device) -> "DeviceDenGraph":
        return _to_device(self, device)

    @staticmethod
    def from_host(g: DenGraph, device="cuda", checkpoint_every: int = 0) -> "DeviceDenGraph":
        states = np.arange(g.num_states, dtype=np.int64)
        in_dst = np.repeat(states, np.diff(g.in_offsets))
        out_src = np.repeat(states, np.diff(g.out_offsets))
        with np.errstate(divide="ignore"):
            log_init = np.log(g.initial_probs.astype(np.float64)).astype(np.float32)

        def t(a, dtype):
            return torch.as_tensor(np.ascontiguousarray(a)).to(device=device, dtype=dtype)

        return DeviceDenGraph(
            in_src=t(g.in_src, torch.int64),
            in_pdf=t(g.in_pdf, torch.int64),
            in_logw=t(g.in_logw, torch.float32),
            in_dst=t(in_dst, torch.int64),
            out_src=t(out_src, torch.int64),
            out_dst=t(g.out_dst, torch.int64),
            out_pdf=t(g.out_pdf, torch.int64),
            out_logw=t(g.out_logw, torch.float32),
            log_init=t(log_init, torch.float32),
            num_states=int(g.num_states),
            num_pdfs=int(g.num_pdfs),
            checkpoint_every=int(checkpoint_every),
        )


@dataclasses.dataclass
class DeviceDenseDenGraph:
    """Dense Moore-machine denominator graph (float32).  The one-hot
    matrices E_mat [E, S] (expanded -> original segment sum) and P_mat
    [P, E] (pdf broadcast) turn the recursion's gathers and scatters into
    matrix products, as in the JAX package; ops/den_dense.py multiplies
    them.  The fused kernels of ops/den_pallas.py index instead: they read
    `orig_of_exp` and the list of each original state's expanded states
    (`orig_offsets` / `orig_exps`, the REAL expanded states only: the
    padded ones have all-zero rows in E_mat although `orig_of_exp` points
    them at state 0).

    Beside the dense V (which ops/den_dense.py and the plain versions
    multiply) the graph holds V's non-zeros twice, built once on the host by
    ops/den_resident.py's `compress`: by expanded state (CSC, what K9f's and
    K9b's h = sigma @ V walk) and by original state (CSR, what K9b's
    v = V @ w walks), entries sorted by index within each column and row, so
    that the kernels' sum order follows from the graph alone.  Indices are
    16-bit (int16 tensors holding unsigned values; `orig16` is orig_of_exp
    so) where S and E are below 65,536, else int32 for the plain versions
    alone: the kernels refuse such a graph.  A copy of the graph with
    another V must be built anew, not `dataclasses.replace`d.

    `fused` chooses the recursion for this graph in ops/chain_loss.py:
    False, ops/den_dense.py (the JAX package's default); True, the fused
    kernels K9f/K9b of ops/den_pallas.py (the JAX package's
    TORCHAIN_USE_PALLAS=1).  The choice is made at `from_host`, by the
    caller or by `auto_den_graph` (which takes the fused form)."""

    V: torch.Tensor  # float32 [S, E]
    E_mat: torch.Tensor  # float32 [E, S] one-hot
    P_mat: torch.Tensor  # float32 [P, E] one-hot
    init_orig: torch.Tensor  # float32 [S]
    orig_of_exp: torch.Tensor  # int32 [E]
    pdf_of_exp: torch.Tensor  # int32 [E]
    orig_offsets: torch.Tensor  # int32 [S + 1]
    orig_exps: torch.Tensor  # int32 [real_exp]
    orig16: torch.Tensor  # int16 (unsigned) [E] orig_of_exp
    csc_offsets: torch.Tensor  # int32 [E + 1]
    csc_rows: torch.Tensor  # int16 (unsigned) [nnz] original state of each entry
    csc_vals: torch.Tensor  # f32 [nnz]
    csr_offsets: torch.Tensor  # int32 [S + 1]
    csr_cols: torch.Tensor  # int16 (unsigned) [nnz] expanded state of each entry
    csr_vals: torch.Tensor  # f32 [nnz]
    num_orig: int
    num_exp: int
    num_pdfs: int
    real_exp: int
    fused: bool = False

    @property
    def nnz(self) -> int:
        return int(self.csc_vals.shape[0])

    def to(self, device) -> "DeviceDenseDenGraph":
        return _to_device(self, device)

    @staticmethod
    def from_host(
        d: DenseDenGraph, device="cuda", fused: bool = False
    ) -> "DeviceDenseDenGraph":
        real = np.arange(d.real_exp)
        E_mat = np.zeros((d.num_exp, d.num_orig), dtype=np.float32)
        E_mat[real, d.orig_of_exp[: d.real_exp]] = 1.0
        P_mat = np.zeros((d.num_pdfs, d.num_exp), dtype=np.float32)
        P_mat[d.pdf_of_exp[: d.real_exp], real] = 1.0
        orig = d.orig_of_exp[: d.real_exp].astype(np.int64)
        counts = np.bincount(orig, minlength=d.num_orig)
        offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
        V = d.V.astype(np.float32)
        index = np.int16 if max(d.num_orig, d.num_exp) < INDEX16_LIMIT else np.int32
        csc_off, csc_rows, csc_vals, csr_off, csr_cols, csr_vals = compress(V, index)
        orig16 = d.orig_of_exp.astype(np.uint16 if index == np.int16 else np.int32)
        t = lambda a: torch.as_tensor(np.ascontiguousarray(a)).to(device)  # noqa: E731
        return DeviceDenseDenGraph(
            V=t(V),
            E_mat=t(E_mat),
            P_mat=t(P_mat),
            init_orig=t(d.initial_probs.astype(np.float32)),
            orig_of_exp=t(d.orig_of_exp.astype(np.int32)),
            pdf_of_exp=t(d.pdf_of_exp.astype(np.int32)),
            orig_offsets=t(offsets),
            orig_exps=t(np.argsort(orig, kind="stable").astype(np.int32)),
            orig16=t(orig16.view(index)),
            csc_offsets=t(csc_off),
            csc_rows=t(csc_rows),
            csc_vals=t(csc_vals),
            csr_offsets=t(csr_off),
            csr_cols=t(csr_cols),
            csr_vals=t(csr_vals),
            num_orig=int(d.num_orig),
            num_exp=int(d.num_exp),
            num_pdfs=int(d.num_pdfs),
            real_exp=int(d.real_exp),
            fused=bool(fused),
        )


#: budget of the dense Moore form's V [S, E] in bytes (float32, both axes
#: padded): the JAX package's DENSE_V_BYTES_THRESHOLD
#: (torchain_tpu/ops/device_graphs.py), kept here as the port's own copy
DENSE_V_BYTES_THRESHOLD = 48 * 1024 * 1024

#: budget of the de Bruijn lift in contexts C = (num_phones + 1)^m: beyond
#: it `auto_den_graph` passes the lift over (its residuals are
#: ~2 * T * B * C * 4 bytes).  The JAX package's DEBRUIJN_MAX_CONTEXTS
DEBRUIJN_MAX_CONTEXTS = 200_000


def den_shared_limit(device) -> int | None:
    """The shared memory a block of the denominator kernels may ask for on
    `device` (the card's opt-in limit), in bytes; None on the CPU, where the
    plain versions run and every form fits."""
    if torch.device(device).type != "cuda":
        return None
    return kernels.entry("den_resident", "den_shared_limit")()


def den_form_indexed(form: str, sizes: tuple) -> bool:
    """Whether the kernels of a denominator form can index its states and
    slots with 16 bits: "resident", sizes (S_pad, K, P), K * S_pad slots;
    "dense", sizes (S, E) padded, both axes.  Sizes alone decide it, on
    every device: on the CPU too a graph past it takes another form, and
    builds no slot-dense or Moore V of its size."""
    if form == "resident":
        S, K, _P = sizes
        return K * S < INDEX16_LIMIT
    return max(sizes) < INDEX16_LIMIT


def den_form_fits(form: str, sizes: tuple, device) -> bool:
    """Whether both kernels of a denominator form can carry a sequence's
    state in one block's shared memory on `device`, decided from sizes alone
    by the library's own counts, as their `shared_plan`s decide it (what
    else a block stages there is optional): "resident", sizes (S_pad, K, P),
    K1 and K2 (ops/den_resident.py); "dense", sizes (S, E) padded, K9f and
    K9b (ops/den_pallas.py).  On the card it also holds the form to
    `den_form_indexed`.  Always True on the CPU, where the plain versions
    run.  With `den_form_indexed`, the fit test of `auto_den_graph`."""
    limit = den_shared_limit(device)
    if limit is None:
        return True
    if form == "resident":
        S, K, P = sizes
        need = kernels.entry("den_resident", "den_shared_bytes")
        fits = lambda bwd: need(bwd, S, K, P, 0, 0, 0) <= limit  # noqa: E731
    else:
        S, E = sizes
        need = kernels.entry("den_dense", "dense_shared_bytes")
        fits = lambda bwd: need(bwd, S, E, 0, 0, 0) <= limit  # noqa: E731
    return den_form_indexed(form, sizes) and fits(0) and fits(1)


def _on_card(device) -> bool:
    return torch.device(device).type == "cuda"


def debruijn_contexts(phone_lm, tree) -> int | None:
    """The contexts C = (num_phones + 1)^m of the de Bruijn lift of
    `phone_lm` over `tree` (graphs/debruijn.py), computed from their sizes;
    None where the lift cannot be built: no LM or tree, an LM not estimated
    by truncation, or a tree whose pdfs depend on the right context (which
    the JAX package's compiler would lift to another graph)."""
    if phone_lm is None or tree is None or lifts_right_context(tree):
        return None
    if not getattr(phone_lm, "debruijn_compatible", False):
        return None
    tail = 2 if (tree.context_dependent(0) or tree.context_dependent(1)) else 1
    m = max(phone_lm.ngram_order - 1, tail, 1)
    return (tree.num_phones + 1) ** m


def auto_den_graph(host_graph: DenGraph, pad_to: int = 128, device="cuda",
                   phone_lm=None, tree=None):
    """The denominator representation for `host_graph` on `device`, in the
    JAX package's order of preference (torchain_tpu/ops/device_graphs.py
    `auto_den_graph`):

      1. the slot-dense graph of ops/den_resident.py (K1, K2) where its
         slots take 16-bit indices and a sequence's carried state fits a
         block's shared memory (on the CPU, the H100's: `carried_bytes`
         against H100_SHARED_LIMIT, so that the CPU takes the form the card
         takes and builds no slot-dense V the card would refuse);
      2. else, on the card, the de Bruijn lift of ops/den_debruijn.py where
         `phone_lm` and `tree` are given, the LM is truncation-estimated, the
         tree has no right context (`debruijn_contexts`) and C stays within
         DEBRUIJN_MAX_CONTEXTS, over the chain topology the port compiles
         every den graph with (`ChainTopology()`).  Never on the CPU, as in
         the JAX package;
      3. else the dense Moore form, fused (K9f, K9b), while its V of
         pad(S) * pad(E) float32 stays within DENSE_V_BYTES_THRESHOLD and
         its states take 16-bit indices and K9's carried state fits;
      4. else the sparse arc list of ops/den_scan.py (plain PyTorch).

    Each test runs on sizes before any V or table is built, through
    `den_form_indexed` and `den_form_fits`:
    the slot layout (`slot_layout`, computed once and built on where the
    resident form is taken) gives S_pad and K, and its distinct (dst, pdf)
    pairs are E.  The padded-table form (ops/den_table.py) and the
    alpha-checkpointed scan are explicit forms: it picks neither, as the JAX
    package does not."""
    layout = slot_layout(host_graph)
    resident = (*layout.sizes(pad_to), host_graph.num_pdfs)
    on_card = _on_card(device)
    if (den_form_indexed("resident", resident) and den_form_fits("resident", resident, device)
            and (on_card or all(carried_bytes(bwd, *resident) <= H100_SHARED_LIMIT
                                for bwd in (0, 1)))):
        return DeviceResidentDenGraph._from_layout(host_graph, layout, pad_to, device)
    C = debruijn_contexts(phone_lm, tree)
    if on_card and C is not None and C <= DEBRUIJN_MAX_CONTEXTS:
        lift = make_debruijn_den_graph(phone_lm, tree, ChainTopology())
        return DeviceDeBruijnDenGraph.from_host(lift, device=device)
    S, E = host_graph.num_states, len(layout.uniq_pdf)
    pad = lambda n: -(-n // pad_to) * pad_to  # noqa: E731
    dense = (pad(S), pad(E))
    if (pad(S) * pad(E) * 4 <= DENSE_V_BYTES_THRESHOLD and den_form_indexed("dense", dense)
            and den_form_fits("dense", dense, device)):
        dense = make_dense_den_graph(host_graph, pad_to=pad_to)
        return DeviceDenseDenGraph.from_host(dense, device=device, fused=True)
    return DeviceDenGraph.from_host(host_graph, device=device)


@dataclasses.dataclass
class DeviceSupervision:
    """Batched packed numerator supervision, SPLIT at the frame-0 /
    steady-state boundary: frame 0 concentrates the normalization FST's
    initial fan-in (up to ~50 arcs/state) while frames >= 1 need only a few
    (arcs are left-packed per (b, t, s) row, so the static split is exact).

    Index tensors are int64 (the dtype torch's gathers take); the JAX
    package narrows them to int16 — the values are identical.
    `frame_vocab` [B, T, W] holds each frame's distinct pdfs (0-padded) and
    `pdf_local*` each arc's index into its frame's vocabulary."""

    in_src0: torch.Tensor  # int64 [B, S, K]
    in_logw0: torch.Tensor  # float32 [B, S, K]
    pdf_local0: torch.Tensor  # int64 [B, S, K]
    in_src_r: torch.Tensor  # int64 [B, T-1, S, Kst]
    in_logw_r: torch.Tensor  # float32 [B, T-1, S, Kst]
    pdf_local_r: torch.Tensor  # int64 [B, T-1, S, Kst]
    final_logw: torch.Tensor  # float32 [B, S]
    weight: torch.Tensor  # float32 [B]
    frame_vocab: torch.Tensor  # int32 [B, T, W]
    num_frames: int
    max_states: int
    max_arcs: int
    num_pdfs: int
    #: arc-slot width of the steady triple (frames >= 1), rounded
    steady_arcs: int = 0
    #: optional per-frame DERIVATIVE weights [B, T] (deriv_weights
    #: semantics, [K] nnet-chain-training.cc ApplyDerivWeights): scale the
    #: output-derivative rows and the xent term, not the objf
    frame_weights: torch.Tensor | None = None
    #: optional steady tables as the resident numerator kernels read them
    #: (ops/num_resident.py `kernel_tables`), filled by
    #: `with_kernel_tables()`: the live-arc list, per-frame offsets int32
    #: [B, T] (K4), 16-byte records int32 [B, L, 4] (K3, K4) and per-frame
    #: destination offsets int32 [B, T-1, S+1] (K3)
    arc_off_k: torch.Tensor | None = None
    arcs_k: torch.Tensor | None = None
    dst_off_k: torch.Tensor | None = None

    def to(self, device) -> "DeviceSupervision":
        return _to_device(self, device)

    def with_kernel_tables(self) -> "DeviceSupervision":
        """A copy that also carries the live-arc list K3 and K4 read,
        prepared once when the batch is placed so that a replayed batch pays
        nothing per step (sizing the list syncs with the device once, here).
        The int64 tables stay for the plain path."""
        if self.in_src_r.shape[1] == 0:
            return self
        arc_off_k, arcs_k, dst_off_k = kernel_tables(
            self.in_src_r, self.pdf_local_r, self.in_logw_r
        )
        return dataclasses.replace(self, arc_off_k=arc_off_k, arcs_k=arcs_k, dst_off_k=dst_off_k)

    @property
    def kernel_pre(self) -> tuple | None:
        """(arc_off_k, arcs_k, dst_off_k), what K3 and K4 read, where
        placed, else None."""
        if self.arcs_k is None:
            return None
        return self.arc_off_k, self.arcs_k, self.dst_off_k

    @staticmethod
    def from_host(s: Supervision, device="cuda") -> "DeviceSupervision":
        """From a batched (pad_and_stack_supervisions) or single supervision;
        a single one gets a leading batch dim of 1."""
        in_src = s.in_src if s.in_src.ndim == 4 else s.in_src[None]
        in_pdf = None
        if s.in_pdf is not None:
            in_pdf = s.in_pdf if s.in_pdf.ndim == 4 else s.in_pdf[None]
        in_logw = s.in_logw if s.in_logw.ndim == 4 else s.in_logw[None]
        final = s.final_logw if s.final_logw.ndim == 2 else s.final_logw[None]
        B = in_src.shape[0]
        pre_fv, pre_pl, pre_need = s.frame_vocab, s.pdf_local, s.steady_need
        cap_v = s.vocab_cap
        if (
            pre_fv is not None
            and pre_pl is not None
            and pre_need is not None
            and (cap_v is None or pre_fv.shape[-1] == cap_v)
        ):
            # tables precomputed at supervision-compile time
            frame_vocab = pre_fv if pre_fv.ndim == 3 else pre_fv[None]
            pdf_local = pre_pl if pre_pl.ndim == 4 else pre_pl[None]
            if cap_v is None and frame_vocab.shape[-1] % 8:
                # single-chunk tables carry the unrounded W; round to 8
                W8 = -(-frame_vocab.shape[-1] // 8) * 8
                pad = W8 - frame_vocab.shape[-1]
                frame_vocab = np.pad(frame_vocab, ((0, 0), (0, 0), (0, pad)))
            need = int(pre_need)
        else:
            if in_pdf is None:
                raise ValueError(
                    "supervision stacked with materialize_pdf=False but "
                    "without precomputed numerator tables; cannot derive "
                    "frame_vocab/pdf_local"
                )
            frame_vocab, pdf_local = _frame_vocab_tables(
                np.asarray(in_src), np.asarray(in_pdf), pad_to=cap_v
            )
            need = 1
            if in_src.shape[1] > 1:
                need = int(max(1, (np.asarray(in_src[:, 1:]) >= 0).sum(-1).max()))
        K = in_src.shape[-1]
        steady = min(K, -(-need // 4) * 4)  # round to 4, capped at K
        if s.steady_cap is not None:
            if need > s.steady_cap:
                raise ValueError(
                    f"steady frames need {need} arc slots > steady cap {s.steady_cap}"
                )
            steady = min(K, int(s.steady_cap))

        def t(a, dtype):
            return torch.as_tensor(np.ascontiguousarray(a)).to(device=device, dtype=dtype)

        return DeviceSupervision(
            in_src0=t(in_src[:, 0], torch.int64),
            in_logw0=t(in_logw[:, 0], torch.float32),
            pdf_local0=t(pdf_local[:, 0], torch.int64),
            in_src_r=t(in_src[:, 1:, :, :steady], torch.int64),
            in_logw_r=t(in_logw[:, 1:, :, :steady], torch.float32),
            pdf_local_r=t(pdf_local[:, 1:, :, :steady], torch.int64),
            final_logw=t(final, torch.float32),
            frame_vocab=t(frame_vocab, torch.int32),
            weight=torch.broadcast_to(
                torch.as_tensor(s.weight, dtype=torch.float32), (B,)
            ).contiguous().to(device),
            num_frames=int(s.num_frames),
            max_states=int(s.max_states),
            max_arcs=int(s.max_arcs),
            num_pdfs=int(s.num_pdfs),
            steady_arcs=steady,
            frame_weights=(
                None
                if s.frame_weights is None
                else t(s.frame_weights, torch.float32)
            ),
        )
