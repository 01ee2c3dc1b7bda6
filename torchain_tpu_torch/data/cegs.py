"""Binary NnetChainExample (cegs) archives: read, write, and convert to
training batches.

Reading merged cegs archives was the defining job of torchain's `io.cc`
(a wrapper of Kaldi's SequentialNnetChainExampleReader); this module
implements the on-disk format of `kaldi/src/nnet3/nnet-chain-example.{h,cc}`
(+ `chain-supervision.cc` Supervision and `nnet-common.cc` Index vectors)
directly, so a Kaldi system's existing egs train without any Kaldi
binaries.  The in-process egs pipeline (data/loader.py) stays the primary
path; this is the interchange path.  Host-side NumPy: a copy of
torchain_tpu/data/cegs.py that writes the same bytes and yields the same
batches; torch enters only where a batch is placed
(ops.DeviceSupervision.from_host).

Format notes (Kaldi binary stream conventions, kaldi/src/base/io-funcs.cc):
  * a record is `key ' ' \\x00B <object>`;
  * WriteToken emits `token + ' '`; WriteBasicType emits a size byte then
    the little-endian payload; bool is one byte 'T'/'F';
  * Index vectors (<I1V>) use nnet-common.cc's delta compression: one
    signed byte per index when only t changes by |dt| < 125, escape 127 +
    full (n, t, x) otherwise;
  * chain::Supervision embeds its FST in OpenFst binary format
    (fstkit/openfst_io.py), e2e supervisions as a counted list of FSTs;
  * NnetIo features are GeneralMatrix bodies (FM/DM/CM/CM2/CM3 — shared
    with io.read_kaldi_matrix_binary).

Byte fidelity is asserted from the format layout plus the committed golden
fixture tests/fixtures/golden_cegs.ark.

Merged examples (`nnet3-chain-merge-egs`) store ONE supervision FST over
num_sequences * frames_per_sequence frames, built by fst::Concat of the
per-sequence FSTs + RmEpsilon + breadth-first sort (chain-supervision.cc
MergeSupervision).  `split_merged_supervision_fst` inverts that exactly:
Concat's epsilon removal stamps each former final state f with a copy of
the next chunk's start arcs shifted by f's final weight, so the boundary
states at depth k*T all carry identical arc sets up to a per-state
constant; the constant is recovered per state (relative to a reference
boundary state) and restored as chunk k-1's final weight, reproducing the
complete-bipartite path pairing of the merged FST exactly.
"""

from __future__ import annotations

import dataclasses
import os
import struct
from typing import BinaryIO, Iterator

import numpy as np

from torchain_tpu_torch.fstkit import Fst
from torchain_tpu_torch.fstkit.openfst_io import read_fst_stream, write_fst_stream, from_fstkit, to_fstkit

# ---------------------------------------------------------------------------
# Kaldi binary stream primitives
# ---------------------------------------------------------------------------


from torchain_tpu_torch.utils.kaldi_io import (  # noqa: F401 — re-exported;
    # the primitives lived here before graphs/transition_model needed
    # them without importing the data package
    _read_exact,
    expect_binary_marker,
    expect_token,
    peek_token_first_char,
    read_basic_bool,
    read_basic_float,
    read_basic_int32,
    read_float_vector,
    read_integer_vector,
    read_token,
    write_basic_bool,
    write_basic_float,
    write_basic_int32,
    write_binary_marker,
    write_float_vector,
    write_integer_vector,
    write_token,
)
# ---------------------------------------------------------------------------
# nnet3 Index vectors (nnet-common.cc)
# ---------------------------------------------------------------------------

_INDEX_ESCAPE = 127
_INDEX_DELTA_LIMIT = 125  # |dt| < 125 fits the one-byte form


def read_index_vector(f: BinaryIO) -> list[tuple[int, int, int]]:
    """<I1V> compressed (n, t, x) index vector."""
    expect_token(f, "<I1V>")
    size = read_basic_int32(f)
    if size < 0 or size > 1_000_000_000:
        raise ValueError(f"implausible index vector size {size}")
    out: list[tuple[int, int, int]] = []
    last = (0, 0, 0)
    for i in range(size):
        c = struct.unpack("<b", _read_exact(f, 1))[0]
        if c == _INDEX_ESCAPE:
            n = read_basic_int32(f)
            t = read_basic_int32(f)
            x = read_basic_int32(f)
            cur = (n, t, x)
        else:
            cur = (last[0], last[1] + c, last[2])
        out.append(cur)
        last = cur
    return out


def write_index_vector(f: BinaryIO, indexes: list[tuple[int, int, int]]) -> None:
    write_token(f, "<I1V>")
    write_basic_int32(f, len(indexes))
    last = (0, 0, 0)
    for idx in indexes:
        n, t, x = idx
        dt = t - last[1]
        if n == last[0] and x == last[2] and abs(dt) < _INDEX_DELTA_LIMIT:
            f.write(struct.pack("<b", dt))
        else:
            f.write(struct.pack("<b", _INDEX_ESCAPE))
            write_basic_int32(f, n)
            write_basic_int32(f, t)
            write_basic_int32(f, x)
        last = idx


# ---------------------------------------------------------------------------
# chain::Supervision
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class KaldiSupervision:
    """chain::Supervision as stored (chain-supervision.h): weight,
    num_sequences, frames_per_sequence, label_dim, and either one merged
    `fst` (standard path) or per-sequence `e2e_fsts` (flat-start path).
    FSTs are fstkit acceptors over pdf_id+1 labels with log-prob weights."""

    weight: float
    num_sequences: int
    frames_per_sequence: int
    label_dim: int
    fst: Fst | None = None
    e2e_fsts: list[Fst] | None = None

    @property
    def is_e2e(self) -> bool:
        return self.e2e_fsts is not None


def _read_embedded_std_fst(f: BinaryIO) -> Fst:
    raw = read_fst_stream(f, allow_stream_counts=False)
    if raw.arctype != "standard":
        raise ValueError(f"supervision FST has arc type {raw.arctype!r}")
    fst, _ = to_fstkit(raw)
    return fst


def _write_embedded_std_fst(f: BinaryIO, fst: Fst) -> None:
    write_fst_stream(f, from_fstkit(fst, arctype="standard"))


def read_supervision(f: BinaryIO) -> KaldiSupervision:
    expect_token(f, "<Supervision>")
    expect_token(f, "<Weight>")
    weight = read_basic_float(f)
    expect_token(f, "<NumSequences>")
    num_sequences = read_basic_int32(f)
    expect_token(f, "<FramesPerSeq>")
    frames_per_sequence = read_basic_int32(f)
    expect_token(f, "<LabelDim>")
    label_dim = read_basic_int32(f)
    fst = None
    e2e_fsts = None
    if peek_token_first_char(f) == "E":
        expect_token(f, "<End2End>")
        if not read_basic_bool(f):
            raise ValueError("<End2End> false is not a written form")
        expect_token(f, "<NumFsts>")
        n = read_basic_int32(f)
        e2e_fsts = [_read_embedded_std_fst(f) for _ in range(n)]
    else:
        fst = _read_embedded_std_fst(f)
    if peek_token_first_char(f) == "A":
        # newer Kaldi appends optional alignment pdfs; parse and drop
        expect_token(f, "<AlignmentPdfs>")
        read_integer_vector(f)
    expect_token(f, "</Supervision>")
    return KaldiSupervision(
        weight=weight,
        num_sequences=num_sequences,
        frames_per_sequence=frames_per_sequence,
        label_dim=label_dim,
        fst=fst,
        e2e_fsts=e2e_fsts,
    )


def write_supervision(f: BinaryIO, sup: KaldiSupervision) -> None:
    write_token(f, "<Supervision>")
    write_token(f, "<Weight>")
    write_basic_float(f, sup.weight)
    write_token(f, "<NumSequences>")
    write_basic_int32(f, sup.num_sequences)
    write_token(f, "<FramesPerSeq>")
    write_basic_int32(f, sup.frames_per_sequence)
    write_token(f, "<LabelDim>")
    write_basic_int32(f, sup.label_dim)
    if sup.e2e_fsts is not None:
        write_token(f, "<End2End>")
        write_basic_bool(f, True)
        write_token(f, "<NumFsts>")
        write_basic_int32(f, len(sup.e2e_fsts))
        for e in sup.e2e_fsts:
            _write_embedded_std_fst(f, e)
    else:
        if sup.fst is None:
            raise ValueError("supervision needs fst or e2e_fsts")
        _write_embedded_std_fst(f, sup.fst)
    write_token(f, "</Supervision>")


# ---------------------------------------------------------------------------
# NnetIo / NnetChainSupervision / NnetChainExample
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class NnetIo:
    name: str  # "input" / "ivector"
    indexes: list[tuple[int, int, int]]  # (n, t, x) per feature row
    features: np.ndarray  # [rows, dim] float32


@dataclasses.dataclass
class NnetChainSupervision:
    name: str  # "output"
    indexes: list[tuple[int, int, int]]
    supervision: KaldiSupervision
    deriv_weights: np.ndarray  # [rows] float32; empty = all-ones


@dataclasses.dataclass
class NnetChainExample:
    inputs: list[NnetIo]
    outputs: list[NnetChainSupervision]

    def io(self, name: str) -> NnetIo:
        for i in self.inputs:
            if i.name == name:
                return i
        raise KeyError(f"no NnetIo named {name!r}")

    def has_io(self, name: str) -> bool:
        return any(i.name == name for i in self.inputs)


def _read_nnet_io(f: BinaryIO) -> NnetIo:
    from torchain_tpu_torch.io import read_kaldi_matrix_binary

    expect_token(f, "<NnetIo>")
    name = read_token(f)
    indexes = read_index_vector(f)
    features = read_kaldi_matrix_binary(f)
    expect_token(f, "</NnetIo>")
    if features.shape[0] != len(indexes):
        raise ValueError(
            f"NnetIo {name!r}: {features.shape[0]} rows != {len(indexes)} indexes"
        )
    return NnetIo(name=name, indexes=indexes, features=features)


def _write_nnet_io(f: BinaryIO, io_: NnetIo, compress: bool = False) -> None:
    from torchain_tpu_torch.io import _encode_cm1, _write_basic_int32

    write_token(f, "<NnetIo>")
    write_token(f, io_.name)
    write_index_vector(f, io_.indexes)
    mat = np.asarray(io_.features, dtype=np.float32)
    if compress:
        f.write(b"CM ")
        _encode_cm1(f, mat)
    else:
        f.write(b"FM ")
        _write_basic_int32(f, mat.shape[0])
        _write_basic_int32(f, mat.shape[1])
        f.write(mat.astype("<f4").tobytes())
    write_token(f, "</NnetIo>")


def _read_chain_supervision(f: BinaryIO) -> NnetChainSupervision:
    expect_token(f, "<NnetChainSup>")
    name = read_token(f)
    indexes = read_index_vector(f)
    supervision = read_supervision(f)
    tok = read_token(f)
    if tok == "<DW2>":
        deriv_weights = read_float_vector(f)
    elif tok == "<DW>":
        # legacy one-byte-per-weight form (WriteVectorAsChar): weights are
        # codes/255 in [0, 1]
        sz = _read_exact(f, 1)
        if sz != b"\x04":
            raise ValueError("bad <DW> vector size byte")
        n = struct.unpack("<i", _read_exact(f, 4))[0]
        codes = np.frombuffer(_read_exact(f, n), dtype=np.uint8)
        deriv_weights = (codes.astype(np.float32) / 255.0).astype(np.float32)
    else:
        raise ValueError(f"expected <DW>/<DW2>, got {tok!r}")
    expect_token(f, "</NnetChainSup>")
    return NnetChainSupervision(
        name=name, indexes=indexes, supervision=supervision, deriv_weights=deriv_weights
    )


def _write_chain_supervision(f: BinaryIO, out: NnetChainSupervision) -> None:
    write_token(f, "<NnetChainSup>")
    write_token(f, out.name)
    write_index_vector(f, out.indexes)
    write_supervision(f, out.supervision)
    write_token(f, "<DW2>")
    write_float_vector(f, out.deriv_weights)
    write_token(f, "</NnetChainSup>")


def read_chain_example(f: BinaryIO) -> NnetChainExample:
    """One NnetChainExample body (after the \\x00B marker)."""
    expect_token(f, "<Nnet3ChainEg>")
    expect_token(f, "<NumInputs>")
    n_in = read_basic_int32(f)
    inputs = [_read_nnet_io(f) for _ in range(n_in)]
    expect_token(f, "<NumOutputs>")
    n_out = read_basic_int32(f)
    outputs = [_read_chain_supervision(f) for _ in range(n_out)]
    expect_token(f, "</Nnet3ChainEg>")
    return NnetChainExample(inputs=inputs, outputs=outputs)


def write_chain_example(f: BinaryIO, eg: NnetChainExample, compress: bool = False) -> None:
    write_token(f, "<Nnet3ChainEg>")
    write_token(f, "<NumInputs>")
    write_basic_int32(f, len(eg.inputs))
    for io_ in eg.inputs:
        _write_nnet_io(f, io_, compress=compress)
    write_token(f, "<NumOutputs>")
    write_basic_int32(f, len(eg.outputs))
    for out in eg.outputs:
        _write_chain_supervision(f, out)
    write_token(f, "</Nnet3ChainEg>")


# ---------------------------------------------------------------------------
# archives
# ---------------------------------------------------------------------------


def iter_cegs_ark(path: str) -> Iterator[tuple[str, NnetChainExample]]:
    """Sequentially read a binary cegs archive (`ark:cegs.1.ark`) — the
    SequentialNnetChainExampleReader role."""
    from torchain_tpu_torch.io import read_ark_key

    with open(path, "rb") as f:
        while True:
            key = read_ark_key(f, what="cegs ark")
            if key is None:
                return
            expect_binary_marker(f)
            yield key, read_chain_example(f)


def read_cegs_ark(path: str) -> dict[str, NnetChainExample]:
    return dict(iter_cegs_ark(path))


def write_cegs_ark(
    path: str,
    egs: "dict[str, NnetChainExample] | list[tuple[str, NnetChainExample]]",
    compress: bool = False,
    scp_path: str | None = None,
) -> None:
    items = egs.items() if isinstance(egs, dict) else egs
    scp = open(scp_path, "w") if scp_path else None
    try:
        with open(path, "wb") as f:
            for key, eg in items:
                if " " in key:
                    raise ValueError("keys must not contain spaces")
                f.write(key.encode() + b" ")
                if scp is not None:
                    scp.write(f"{key} {path}:{f.tell()}\n")
                write_binary_marker(f)
                write_chain_example(f, eg, compress=compress)
    finally:
        if scp is not None:
            scp.close()


# ---------------------------------------------------------------------------
# merge / split of supervision FSTs (chain-supervision.cc MergeSupervision)
# ---------------------------------------------------------------------------


def _state_depths(fst: Fst, expect_max: int | None = None) -> list[int]:
    """Frame of every state; valid because supervision FSTs are
    frame-synchronous (every arc advances one frame) and connected."""
    depth = [-1] * fst.num_states
    depth[0] = 0
    order = [0]
    head = 0
    while head < len(order):
        s = order[head]
        head += 1
        for a in fst.arcs(s):
            if depth[a.dst] == -1:
                depth[a.dst] = depth[s] + 1
                order.append(a.dst)
            elif depth[a.dst] != depth[s] + 1:
                raise ValueError(
                    "supervision FST is not frame-synchronous (state "
                    f"{a.dst} reachable at depths {depth[a.dst]} and {depth[s] + 1})"
                )
    if expect_max is not None and max(depth) != expect_max:
        raise ValueError(
            f"supervision FST spans {max(depth)} frames, expected {expect_max}"
        )
    return depth


def merge_supervision_fsts(fsts: list[Fst], frames_per_sequence: int) -> Fst:
    """fst::Concat + RmEpsilon + breadth-first sort, as MergeSupervision
    builds the stored FST of a merged example (chain-supervision.cc)."""
    from torchain_tpu_torch.fstkit import bfs_time_sort, connect, rm_epsilon

    merged = fsts[0].copy()
    for nxt in fsts[1:]:
        base = merged.num_states
        out = Fst()
        out.add_states(base + nxt.num_states)
        for s, a in merged.all_arcs():
            out.add_arc(s, a.label, a.weight, a.dst)
        for s, a in nxt.all_arcs():
            out.add_arc(base + s, a.label, a.weight, base + a.dst)
        for s in range(merged.num_states):
            if merged.is_final(s):
                # Concat: final weight becomes the epsilon arc into nxt's start
                out.add_arc(s, 0, merged.final(s), base + 0)
        for s in range(nxt.num_states):
            if nxt.is_final(s):
                out.set_final(base + s, nxt.final(s))
        merged = out
    merged = rm_epsilon(merged)
    merged = connect(merged)
    merged = bfs_time_sort(merged)
    _state_depths(merged, expect_max=frames_per_sequence * len(fsts))
    return merged


def split_merged_supervision_fst(
    fst: Fst, num_sequences: int, frames_per_sequence: int, tol: float = 1e-4
) -> list[Fst]:
    """Exact inverse of merge_supervision_fsts — see the module docstring
    for why the per-boundary-state constant recovery is exact."""
    T = frames_per_sequence
    if num_sequences == 1:
        return [fst]
    depth = _state_depths(fst, expect_max=num_sequences * T)
    states_at: dict[int, list[int]] = {}
    for s, d in enumerate(depth):
        states_at.setdefault(d, []).append(s)

    def sorted_arcs(s: int):
        return sorted(fst.arcs(s), key=lambda a: (a.label, a.dst, a.weight))

    pieces: list[Fst] = []
    # start-arc source for the current piece: state 0 for piece 0, the
    # reference boundary state afterwards
    cur_start_arcs = list(fst.arcs(0))
    for k in range(num_sequences):
        lo, hi = k * T, (k + 1) * T
        piece = Fst()
        new_id: dict[int, int] = {}
        start = piece.add_state()
        for d in range(lo + 1, hi + 1):
            for s in states_at.get(d, []):
                new_id[s] = piece.add_state()
        for a in cur_start_arcs:
            piece.add_arc(start, a.label, a.weight, new_id[a.dst])
        for d in range(lo + 1, hi):
            for s in states_at.get(d, []):
                for a in fst.arcs(s):
                    piece.add_arc(new_id[s], a.label, a.weight, new_id[a.dst])
        boundary = states_at.get(hi, [])
        if not boundary:
            raise ValueError(f"no states at frame {hi}; bad merged FST")
        if k == num_sequences - 1:
            for s in boundary:
                if not fst.is_final(s):
                    raise ValueError("non-final state at the last frame")
                piece.set_final(new_id[s], fst.final(s))
        else:
            # recover chunk-final weights: boundary arcs are copies of the
            # next chunk's start arcs shifted by the former final weight
            ref = boundary[0]
            ref_arcs = sorted_arcs(ref)
            if not ref_arcs:
                raise ValueError(f"boundary state {ref} has no arcs")
            for s in boundary:
                sa = sorted_arcs(s)
                if len(sa) != len(ref_arcs):
                    raise ValueError(
                        "boundary states disagree on arc structure; this FST "
                        "was not produced by MergeSupervision-style concat"
                    )
                c = sa[0].weight - ref_arcs[0].weight
                for a, r in zip(sa, ref_arcs):
                    if a.label != r.label or depth[a.dst] != depth[r.dst] or \
                            abs((a.weight - r.weight) - c) > tol:
                        raise ValueError(
                            "boundary states disagree beyond a constant "
                            "offset; this FST was not produced by "
                            "MergeSupervision-style concat"
                        )
                piece.set_final(new_id[s], c)
            cur_start_arcs = list(fst.arcs(ref))
        pieces.append(piece)
    return pieces


# ---------------------------------------------------------------------------
# conversion to training batches
# ---------------------------------------------------------------------------


def _rows_to_batch(indexes: list[tuple[int, int, int]], feats: np.ndarray) -> np.ndarray:
    """Reorder NnetIo rows into [B, T, F] by (n, t) — robust to either the
    example-major layout merged egs store or computation-order layouts."""
    ns = sorted({i[0] for i in indexes})
    ts = sorted({i[1] for i in indexes})
    if ns != list(range(len(ns))):
        raise ValueError(f"non-contiguous sequence indexes {ns[:8]}...")
    n_of = {n: i for i, n in enumerate(ns)}
    t_of = {t: i for i, t in enumerate(ts)}
    out = np.zeros((len(ns), len(ts), feats.shape[1]), dtype=np.float32)
    seen = np.zeros((len(ns), len(ts)), dtype=bool)
    for row, (n, t, _x) in enumerate(indexes):
        bi, ti = n_of[n], t_of[t]
        if seen[bi, ti]:
            raise ValueError(f"duplicate index (n={n}, t={t})")
        seen[bi, ti] = True
        out[bi, ti] = feats[row]
    if not seen.all():
        raise ValueError("index grid has holes; not a dense (n, t) layout")
    return out


def example_to_batch(
    eg: NnetChainExample,
    append_ivector: bool = True,
    sup_caps: "tuple[int, ...] | None" = None,
    ignore_deriv_weights: bool = False,
):
    """Convert one (possibly merged) NnetChainExample into a ChainBatch:
    features reordered to [B, T_in, F] (ivector tiled and appended per
    frame when present, matching the recipe's use of online ivectors), and
    the supervision FST split back into per-sequence FSTs, compiled and
    stacked with the in-process pipeline's own machinery.

    Non-uniform deriv_weights become the supervision's `frame_weights`
    [B, T_out] (on the same (n, t) grid), which the chain loss applies as
    per-frame derivative scales; `ignore_deriv_weights` drops them.
    """
    from torchain_tpu_torch.data.loader import ChainBatch
    from torchain_tpu_torch.graphs.supervision import (
        compile_supervision,
        pad_and_stack_supervisions,
    )

    out = eg.outputs[0]
    sup = out.supervision
    dw = out.deriv_weights
    fw = None  # per-frame derivative weights [B, T_out], or None = all-ones
    if (
        not ignore_deriv_weights
        and dw.size
        and not np.allclose(dw, 1.0, atol=1e-3)
    ):
        # reorder rows onto the dense (n, t) grid exactly as the features
        # are; applied by the loss as derivative row scales
        # (kaldi/src/nnet3/nnet-chain-training.cc ApplyDerivWeights)
        fw = _rows_to_batch(
            out.indexes, np.asarray(dw, np.float32)[:, None]
        )[..., 0]
    feats = _rows_to_batch(eg.io("input").indexes, eg.io("input").features)
    B = sup.num_sequences
    if feats.shape[0] != B:
        raise ValueError(
            f"feature batch {feats.shape[0]} != num_sequences {B}"
        )
    if append_ivector and eg.has_io("ivector"):
        ivec = eg.io("ivector")
        rows = _rows_to_batch(ivec.indexes, ivec.features)  # [B, n_ivec_t, D]
        # online ivectors: egs made with --online-ivector-period carry one
        # row per period; Kaldi's computation selects the nearest-t row for
        # each frame, so do the same over the (n, t) index grids
        ivec_ts = np.array(sorted({i[1] for i in ivec.indexes}))
        in_ts = np.array(sorted({i[1] for i in eg.io("input").indexes}))
        sel = np.abs(in_ts[:, None] - ivec_ts[None, :]).argmin(axis=1)
        feats = np.concatenate([feats, rows[:, sel, :]], axis=2)
    if sup.is_e2e:
        # flat-start records: per-sequence CYCLIC numerator FSTs
        # (chain-generic-numerator path, nnet-chain-example.h 'e2e').
        # Compile straight into the e2e supervision packing the trainer
        # already dispatches on (ops/num_e2e.DeviceE2eSupervision).
        from torchain_tpu_torch.graphs.e2e import (
            compile_e2e_supervision,
            pad_and_stack_e2e,
        )

        if len(sup.e2e_fsts) != B:
            raise ValueError(
                f"e2e record has {len(sup.e2e_fsts)} fsts but "
                f"num_sequences={B}"
            )
        caps_s = sup_caps[0] if sup_caps else None
        caps_a = sup_caps[1] if sup_caps and len(sup_caps) > 1 else None
        compiled_e2e = [
            compile_e2e_supervision(
                f,
                sup.frames_per_sequence,
                sup.label_dim,
                weight=sup.weight,
                max_states=caps_s,
                max_arcs=caps_a,
            )
            for f in sup.e2e_fsts
        ]
        stacked_e2e = pad_and_stack_e2e(compiled_e2e)
        stacked_e2e.frame_weights = fw
        return ChainBatch(feats=feats, sup=stacked_e2e)
    pieces = split_merged_supervision_fst(
        sup.fst, B, sup.frames_per_sequence
    )
    compiled = [
        compile_supervision(p, sup.label_dim, weight=sup.weight) for p in pieces
    ]
    pads = {}
    if sup_caps:
        pads = dict(
            pad_states_to=sup_caps[0],
            pad_arcs_to=sup_caps[1],
            pad_vocab_to=sup_caps[2] if len(sup_caps) > 2 else None,
            pad_steady_to=sup_caps[3] if len(sup_caps) > 3 else None,
        )
    stacked = pad_and_stack_supervisions(compiled, **pads)
    stacked.frame_weights = fw
    return ChainBatch(feats=feats, sup=stacked)


def _assemble_example(
    feats: np.ndarray,  # [B, T_in, F]
    sup: KaldiSupervision,
    frame_subsampling_factor: int,
    left_context: int,
    ivectors: "np.ndarray | None",
) -> NnetChainExample:
    """Shared NnetChainExample assembly: example-major index grids with
    input t starting at -left_context and output t on the
    frame_subsampling_factor grid, as nnet3-chain-get-egs + merge-egs
    produce."""
    B, T_in, _F = feats.shape
    fsf = frame_subsampling_factor
    T_out = sup.frames_per_sequence
    in_indexes = [
        (n, t - left_context, 0) for n in range(B) for t in range(T_in)
    ]
    out_indexes = [(n, t * fsf, 0) for n in range(B) for t in range(T_out)]
    inputs = [
        NnetIo(
            name="input",
            indexes=in_indexes,
            features=feats.reshape(B * T_in, -1).astype(np.float32),
        )
    ]
    if ivectors is not None:
        inputs.append(
            NnetIo(
                name="ivector",
                indexes=[(n, 0, 0) for n in range(B)],
                features=np.asarray(ivectors, dtype=np.float32),
            )
        )
    outputs = [
        NnetChainSupervision(
            name="output",
            indexes=out_indexes,
            supervision=sup,
            deriv_weights=np.ones(B * T_out, dtype=np.float32),
        )
    ]
    return NnetChainExample(inputs=inputs, outputs=outputs)


def make_chain_example(
    feats: np.ndarray,  # [B, T_in, F] input-rate features (context included)
    sup_fsts: list[Fst],  # per-sequence supervision FSTs (pdf_id+1 labels)
    label_dim: int,
    frame_subsampling_factor: int = 3,
    weight: float = 1.0,
    left_context: int = 0,
    ivectors: np.ndarray | None = None,  # [B, D]
) -> NnetChainExample:
    """Build a (merged) NnetChainExample from in-process pipeline pieces —
    the export direction of the interchange: write egs a Kaldi system can
    train on."""
    B = feats.shape[0]
    depths = [_state_depths(f) for f in sup_fsts]
    T_out = max(depths[0]) if depths else 0
    for d in depths:
        if max(d) != T_out:
            raise ValueError("all sequences must share frames_per_sequence")
    merged = merge_supervision_fsts(sup_fsts, T_out) if len(sup_fsts) > 1 else sup_fsts[0]
    sup = KaldiSupervision(
        weight=weight,
        num_sequences=B,
        frames_per_sequence=T_out,
        label_dim=label_dim,
        fst=merged,
    )
    return _assemble_example(
        feats, sup, frame_subsampling_factor, left_context, ivectors
    )


def make_e2e_chain_example(
    feats: np.ndarray,  # [B, T_in, F] input-rate features (context included)
    e2e_fsts: list[Fst],  # per-sequence CYCLIC supervision FSTs (pdf_id+1)
    label_dim: int,
    frames_per_sequence: int,
    frame_subsampling_factor: int = 3,
    weight: float = 1.0,
    left_context: int = 0,
    ivectors: np.ndarray | None = None,  # [B, D]
) -> NnetChainExample:
    """Flat-start counterpart of make_chain_example: the supervision is a
    counted list of per-sequence cyclic FSTs (`e2e_fsts`), as
    nnet3-chain-get-egs writes for e2e/flat-start preps
    (nnet-chain-example.h e2e branch).  frames_per_sequence must be passed
    explicitly — cyclic FSTs carry no time structure."""
    B = feats.shape[0]
    if len(e2e_fsts) != B:
        raise ValueError(f"{len(e2e_fsts)} fsts for batch {B}")
    sup = KaldiSupervision(
        weight=weight,
        num_sequences=B,
        frames_per_sequence=frames_per_sequence,
        label_dim=label_dim,
        fst=None,
        e2e_fsts=list(e2e_fsts),
    )
    return _assemble_example(
        feats, sup, frame_subsampling_factor, left_context, ivectors
    )


def batches_from_cegs(
    path: str, append_ivector: bool = True, ignore_deriv_weights: bool = False
):
    """Iterate training-ready ChainBatches straight off a cegs archive."""
    for key, eg in iter_cegs_ark(path):
        yield key, example_to_batch(
            eg,
            append_ivector=append_ivector,
            ignore_deriv_weights=ignore_deriv_weights,
        )


class CegsDataset:
    """Train DIRECTLY from merged Kaldi cegs archives — the torchain
    example workflow (example/train.py over src/io.cc's ExampleReader: a
    completed Kaldi chain prep ships den.fst + merged cegs, and training
    iterates the archives).  Duck-types the ChainDataset surface
    (`batches`, `estimate_sup_caps`, `estimate_live_arcs`), so a training
    loop written for the in-process dataset runs unchanged on foreign egs.

    Each merged record IS one minibatch (its num_sequences is the batch
    size chosen at merge time), so the `batch_size` argument of
    `batches()` is ignored; archive order reshuffles per (seed, epoch)
    like the recipe's per-iteration archive schedule, and records are
    round-robin sharded across processes (multi-host runs additionally
    need shape-uniform archives, which nnet3-chain-merge-egs's
    equal-length grouping produces, plus sup_caps for fixed supervision
    padding)."""

    def __init__(
        self,
        paths: "list[str] | str",
        append_ivector: bool = True,
        seed: int = 0,
        ignore_deriv_weights: bool = False,
    ):
        import glob as _glob

        if isinstance(paths, str):
            expanded: list[str] = []
            for part in paths.split(","):
                hits = sorted(_glob.glob(part))
                expanded.extend(hits if hits else [part])
            paths = expanded
        self.paths = list(paths)
        if not self.paths:
            raise ValueError("no cegs archives given")
        for p in self.paths:
            if not os.path.exists(p):
                raise FileNotFoundError(f"cegs archive not found: {p}")
        self.append_ivector = append_ivector
        self.seed = seed
        self.ignore_deriv_weights = ignore_deriv_weights
        self._n_records: "int | None" = None
        self._scan_result = None

    def count_records(self) -> int:
        """Total merged records across all archives (one counting pass on
        first call, cached) — needed to truncate multi-process epochs to
        a common length."""
        if self._n_records is None:
            n = 0
            for p in self.paths:
                for _key, _eg in iter_cegs_ark(p):
                    n += 1
            self._n_records = n
        return self._n_records

    def peek(self):
        """(feat_dim, num_pdfs, batch_size, frames_per_sequence) of the
        first record — the model/den-graph construction inputs."""
        for _key, eg in iter_cegs_ark(self.paths[0]):
            b = example_to_batch(
                eg,
                append_ivector=self.append_ivector,
                ignore_deriv_weights=self.ignore_deriv_weights,
            )
            return (
                int(b.feats.shape[2]),
                int(b.sup.num_pdfs),
                int(b.feats.shape[0]),
                int(b.sup.num_frames),
            )
        raise ValueError(f"empty cegs archive: {self.paths[0]}")

    def estimate_sup_caps(self) -> tuple[int, int, int, int]:
        """Maxima of the per-record padded supervision dims (states, arcs,
        frame vocab, steady arcs) over every archive — the fixed padding
        multi-host runs need.  One full pass (compiles each record's
        supervision once; O(egs)), shared with `estimate_live_arcs`."""
        return self._scan()[0]

    def estimate_live_arcs(self) -> int:
        """The most live steady arcs (frames >= 1) of any sequence of any
        record: the `L_cap` of `DeviceSupervision.with_kernel_tables` that
        gives every batch one live-arc list shape, as a captured train step
        needs (`ChainDataset.estimate_live_arcs`).  Flat-start records have
        no fixed shape of their own: ValueError."""
        live = self._scan()[1]
        if live is None:
            raise ValueError("flat-start (e2e) cegs records: no live-arc width fixes their"
                             " batches' shape")
        return live

    def _scan(self):
        """(estimate_sup_caps, estimate_live_arcs or None where a record is
        flat-start), one pass over every archive, kept."""
        if self._scan_result is not None:
            return self._scan_result
        from torchain_tpu_torch.graphs.e2e import E2eSupervision

        ms = ma = mv = mst = live = 1
        e2e = False
        for p in self.paths:
            for _key, b in batches_from_cegs(
                p, self.append_ivector, self.ignore_deriv_weights
            ):
                s = b.sup
                ms = max(ms, int(s.max_states))
                ma = max(ma, int(s.in_src.shape[-1]))
                # e2e supervisions have no frame-vocab/steady packing;
                # their caps are just (states, arcs)
                fv = getattr(s, "frame_vocab", None)
                if fv is not None:
                    mv = max(mv, int(fv.shape[-1]))
                sn = getattr(s, "steady_need", None)
                if sn is not None:
                    mst = max(mst, int(np.max(sn)))
                if isinstance(s, E2eSupervision):
                    e2e = True
                else:
                    src = s.in_src if s.in_src.ndim == 4 else s.in_src[None]
                    n = (src[:, 1:] >= 0).reshape(src.shape[0], -1).sum(1)
                    live = max(live, int(n.max()))
        r = lambda x, m: ((x + m - 1) // m) * m  # noqa: E731
        caps = r(ms, 4), r(ma, 4), r(mv, 8), r(mst, 4)
        self._scan_result = caps, (None if e2e else live)
        return self._scan_result

    def batches(
        self,
        batch_size: int,  # ignored: merged records fix the batch size
        shuffle: bool = True,
        drop_last: bool = True,
        epoch: "int | None" = None,
        process_index: "int | None" = None,
        process_count: "int | None" = None,
        sup_caps: "tuple[int, ...] | None" = None,
        num_threads: "int | None" = None,
    ):
        del batch_size, drop_last, num_threads
        order = list(range(len(self.paths)))
        if shuffle:
            rng = np.random.default_rng(
                [self.seed & 0x7FFFFFFF, int(epoch or 0)]
            )
            rng.shuffle(order)
        pi = process_index or 0
        pc = process_count or 1
        # Truncate every process's epoch to the common minimum
        # (total // pc): with round-robin sharding alone, a total not
        # divisible by pc leaves some processes one record ahead, and the
        # collective train step would hang at epoch end waiting on peers
        # that already finished.
        limit = self.count_records() // pc if pc > 1 else None
        rec = 0
        taken = 0
        for ai in order:
            for _key, eg in iter_cegs_ark(self.paths[ai]):
                take = rec % pc == pi
                rec += 1
                if not take:
                    continue
                if limit is not None and taken >= limit:
                    return
                taken += 1
                yield example_to_batch(
                    eg,
                    append_ivector=self.append_ivector,
                    sup_caps=sup_caps,
                    ignore_deriv_weights=self.ignore_deriv_weights,
                )


def dataset_to_cegs(
    dataset,
    path: str,
    batch_size: int,
    compress: bool = False,
    scp_path: str | None = None,
    shuffle_seed: int | None = None,
) -> int:
    """Export a ChainDataset's chunks as a MERGED binary cegs archive —
    the offline half of Kaldi's egs pipeline (nnet3-chain-get-egs |
    shuffle-egs | merge-egs, kaldi/src/chainbin) as one in-process step:
    chunk alignments are compiled to supervision FSTs composed with the
    normalization FST, grouped `batch_size` equal-length chunks per record, and written with
    the interchange writer so a Kaldi system (or batches_from_cegs) can
    train on the archive directly.  Returns the number of records."""
    import collections

    from torchain_tpu_torch.fstkit import compose
    from torchain_tpu_torch.graphs.supervision import alignment_to_supervision_fst

    # compile every chunk's supervision FST first, dropping failures the
    # way the training loader (and Kaldi's get-egs) does
    by_t: "dict[int, list[tuple[int, Fst]]]" = collections.defaultdict(list)
    for ci, (_ui, _c0, t_out, chunk_ali, lctx, rctx) in enumerate(
        dataset.chunks
    ):
        try:
            fst = alignment_to_supervision_fst(
                chunk_ali,
                dataset.tree,
                dataset.sup_opts,
                left_context_phone=lctx,
                right_context_phone=rctx,
            )
            fst = compose(fst, dataset._norm_ready, b_ready=True)
        except ValueError:
            continue
        by_t[t_out].append((ci, fst))
    if shuffle_seed is not None:
        rng = np.random.default_rng(shuffle_seed)
        for items in by_t.values():
            rng.shuffle(items)
    n = 0
    egs: list[tuple[str, NnetChainExample]] = []
    for t_out in sorted(by_t):
        items = by_t[t_out]
        for b0 in range(0, len(items) - batch_size + 1, batch_size):
            group = items[b0 : b0 + batch_size]
            feats = []
            for ci, _fst in group:
                ui, c0, t, *_rest = dataset.chunks[ci]
                feats.append(dataset._chunk_feats(dataset.utts[ui], c0, t))
            eg = make_chain_example(
                np.stack(feats),
                [f for _ci, f in group],
                dataset.tree.num_pdfs,
                frame_subsampling_factor=dataset.fsf,
                left_context=dataset.left_context,
            )
            egs.append((f"eg-{n:06d}", eg))
            n += 1
    write_cegs_ark(path, egs, compress=compress, scp_path=scp_path)
    return n
