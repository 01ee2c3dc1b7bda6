"""OpenFst BINARY format read/write (VectorFst + ConstFst containers).

A real Kaldi chain system ships its graphs as binary OpenFst files —
`den.fst` / `normalization.fst` as StdVectorFst (written by
chain-make-den-fst via kaldi/src/fstext/kaldi-fst-io), `HCLG.fst` usually
converted to ConstFst by utils/mkgraph.sh, and lattices as VectorFst over
Kaldi's Lattice / CompactLattice arc types (kaldi/src/lat/kaldi-lattice.cc).
This module implements the on-disk format so those artifacts are directly
consumable (and producible) without OpenFst or Kaldi binaries.

Format (openfst/src/include/fst/fst.h FstHeader, vector-fst.h, const-fst.h):

  header:  int32 magic 2125659606, string fsttype ("vector"/"const"),
           string arctype, int32 version, int32 flags (1=isymbols,
           2=osymbols, 4=aligned), uint64 properties, int64 start,
           int64 numstates, int64 numarcs.  Strings are int32 length +
           bytes; everything little-endian.
  symbols: optional SymbolTables follow the header when flagged (Kaldi
           graphs are written without; we parse-and-skip them).
  vector body (version 2): per state: final weight, int64 narcs, then
           per arc: int32 ilabel, int32 olabel, weight, int32 nextstate.
  const body: POD ConstState array {weight, uint32 pos/narcs/
           niepsilons/noepsilons} then POD arc array; version 1 files
           align each array to 16 bytes from file start, version 2
           files don't.

Weight encodings by arc type:
  "standard"          TropicalWeight: one float32 cost
  "lattice4"          Kaldi LatticeWeight: two float32 costs
                      (graph_cost, acoustic_cost)
  "compactlattice44"  Kaldi CompactLatticeWeight: LatticeWeight + an
                      int32-vector "string" (transition-id alignment)

Byte-level fidelity is asserted from the format layout above plus the
round-trip golden fixtures tests/fixtures/golden_*.fst.  Conversion to/from
fstkit.Fst flips sign (OpenFst stores costs, fstkit stores log-probs).
A host-side copy of torchain_tpu/fstkit/openfst_io.py: the same bytes for
the same FSTs.
"""

from __future__ import annotations

import dataclasses
import math
import struct
from typing import BinaryIO

from torchain_tpu_torch.fstkit.fst import Fst

FST_MAGIC = 2125659606
SYMBOL_TABLE_MAGIC = 2125658996

FLAG_HAS_ISYMBOLS = 0x1
FLAG_HAS_OSYMBOLS = 0x2
FLAG_IS_ALIGNED = 0x4

VECTOR_FILE_VERSION = 2
CONST_FILE_VERSION = 2
CONST_ALIGNED_FILE_VERSION = 1
CONST_ALIGN = 16

INF = float("inf")

# properties: kExpanded | kMutable is what VectorFst stamps at minimum; we
# write only kExpanded-style bits readers ignore, and ignore them on read.
PROPS_EXPANDED = 0x1
PROPS_MUTABLE = 0x2


# ---------------------------------------------------------------------------
# low-level codecs (OpenFst util.h WriteType/ReadType)
# ---------------------------------------------------------------------------


def _read(f: BinaryIO, n: int) -> bytes:
    b = f.read(n)
    if len(b) != n:
        raise ValueError(f"truncated OpenFst stream (wanted {n} bytes, got {len(b)})")
    return b


def _read_i32(f) -> int:
    return struct.unpack("<i", _read(f, 4))[0]


def _read_i64(f) -> int:
    return struct.unpack("<q", _read(f, 8))[0]


def _read_u64(f) -> int:
    return struct.unpack("<Q", _read(f, 8))[0]


def _read_f32(f) -> float:
    return struct.unpack("<f", _read(f, 4))[0]


def _read_string(f) -> str:
    n = _read_i32(f)
    if n < 0 or n > 1_000_000:
        raise ValueError(f"implausible OpenFst string length {n}")
    return _read(f, n).decode("utf-8", errors="replace")


def _w_i32(f, v: int) -> None:
    f.write(struct.pack("<i", v))


def _w_i64(f, v: int) -> None:
    f.write(struct.pack("<q", v))


def _w_u64(f, v: int) -> None:
    f.write(struct.pack("<Q", v))


def _w_f32(f, v: float) -> None:
    f.write(struct.pack("<f", v))


def _w_string(f, s: str) -> None:
    b = s.encode("utf-8")
    _w_i32(f, len(b))
    f.write(b)


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------

#: weight tuple layouts: name -> (n_floats, has_string)
ARC_TYPES = {
    "standard": (1, False),
    "lattice4": (2, False),
    "compactlattice44": (2, True),
}


def _read_weight(f, arctype: str):
    nfl, has_str = ARC_TYPES[arctype]
    vals = tuple(_read_f32(f) for _ in range(nfl))
    if has_str:
        n = _read_i32(f)
        if n < 0 or n > 100_000_000:
            raise ValueError(f"implausible CompactLattice string length {n}")
        s = struct.unpack(f"<{n}i", _read(f, 4 * n)) if n else ()
        return vals + (tuple(s),)
    return vals


def _write_weight(f, arctype: str, w) -> None:
    nfl, has_str = ARC_TYPES[arctype]
    for i in range(nfl):
        _w_f32(f, w[i])
    if has_str:
        s = w[nfl] if len(w) > nfl else ()
        _w_i32(f, len(s))
        if s:
            f.write(struct.pack(f"<{len(s)}i", *s))


def _zero_weight(arctype: str):
    """Semiring Zero (the 'non-final' weight): +inf costs, empty string."""
    nfl, has_str = ARC_TYPES[arctype]
    w = (INF,) * nfl
    return w + ((),) if has_str else w


def _is_zero(w) -> bool:
    return math.isinf(w[0]) and w[0] > 0


# ---------------------------------------------------------------------------
# container
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RawArc:
    ilabel: int
    olabel: int
    weight: tuple  # per-arctype layout (see ARC_TYPES)
    nextstate: int


@dataclasses.dataclass
class RawFst:
    """Exactly what the file stores: a transducer in cost semirings."""

    fsttype: str
    arctype: str
    start: int
    #: per-state final weight tuple; semiring Zero = non-final
    finals: list
    #: per-state arc lists
    arcs: list

    @property
    def num_states(self) -> int:
        return len(self.finals)

    @property
    def num_arcs(self) -> int:
        return sum(len(a) for a in self.arcs)


# ---------------------------------------------------------------------------
# header
# ---------------------------------------------------------------------------


def _read_header(f):
    magic = _read_i32(f)
    if magic != FST_MAGIC:
        raise ValueError(
            f"not an OpenFst binary file (magic {magic}, expected {FST_MAGIC})"
        )
    fsttype = _read_string(f)
    arctype = _read_string(f)
    version = _read_i32(f)
    flags = _read_i32(f)
    properties = _read_u64(f)
    start = _read_i64(f)
    numstates = _read_i64(f)
    numarcs = _read_i64(f)
    return fsttype, arctype, version, flags, properties, start, numstates, numarcs


def _write_header(
    f, fsttype, arctype, version, flags, properties, start, numstates, numarcs
):
    _w_i32(f, FST_MAGIC)
    _w_string(f, fsttype)
    _w_string(f, arctype)
    _w_i32(f, version)
    _w_i32(f, flags)
    _w_u64(f, properties)
    _w_i64(f, start)
    _w_i64(f, numstates)
    _w_i64(f, numarcs)


def _skip_symbol_table(f) -> None:
    """Parse past an embedded SymbolTable (symbol-table.cc binary format:
    magic, name string, int64 available_key, int64 size, then per entry a
    string symbol + int64 key).  Kaldi graphs don't embed tables, but
    fstcompile --keep_isymbols output does."""
    magic = _read_i32(f)
    if magic != SYMBOL_TABLE_MAGIC:
        raise ValueError(f"bad SymbolTable magic {magic}")
    _read_string(f)  # name
    _read_i64(f)  # available key
    size = _read_i64(f)
    for _ in range(size):
        _read_string(f)
        _read_i64(f)


# ---------------------------------------------------------------------------
# vector body
# ---------------------------------------------------------------------------


def _read_vector_body(f, arctype: str, numstates: int) -> tuple[list, list]:
    finals, arcs = [], []
    n = 0
    while numstates < 0 or n < numstates:
        if numstates < 0:
            # stream-written header (numstates == -1): states run to EOF
            probe = f.read(1)
            if not probe:
                break
            f.seek(-1, 1)
        final = _read_weight(f, arctype)
        narcs = _read_i64(f)
        if narcs < 0 or narcs > 1_000_000_000:
            raise ValueError(f"implausible arc count {narcs}")
        state_arcs = []
        for _ in range(narcs):
            il = _read_i32(f)
            ol = _read_i32(f)
            w = _read_weight(f, arctype)
            ns = _read_i32(f)
            state_arcs.append(RawArc(il, ol, w, ns))
        finals.append(final)
        arcs.append(state_arcs)
        n += 1
    return finals, arcs


def _write_vector_body(f, raw: RawFst) -> None:
    for s in range(raw.num_states):
        _write_weight(f, raw.arctype, raw.finals[s])
        _w_i64(f, len(raw.arcs[s]))
        for a in raw.arcs[s]:
            _w_i32(f, a.ilabel)
            _w_i32(f, a.olabel)
            _write_weight(f, raw.arctype, a.weight)
            _w_i32(f, a.nextstate)


# ---------------------------------------------------------------------------
# const body
# ---------------------------------------------------------------------------


def _align(f, write: bool) -> None:
    pos = f.tell()
    pad = (-pos) % CONST_ALIGN
    if pad:
        if write:
            f.write(b"\x00" * pad)
        else:
            _read(f, pad)


def _read_const_body(f, arctype: str, numstates: int, numarcs: int, aligned: bool):
    if arctype == "compactlattice44":
        raise ValueError("ConstFst cannot hold variable-size CompactLattice weights")
    nfl, _ = ARC_TYPES[arctype]
    if aligned:
        _align(f, write=False)
    states = []
    st_fmt = "<" + "f" * nfl + "IIII"
    st_size = struct.calcsize(st_fmt)
    buf = _read(f, st_size * numstates)
    for i in range(numstates):
        rec = struct.unpack_from(st_fmt, buf, i * st_size)
        final = tuple(rec[:nfl])
        pos, narcs = rec[nfl], rec[nfl + 1]
        states.append((final, pos, narcs))
    if aligned:
        _align(f, write=False)
    arc_fmt = "<ii" + "f" * nfl + "i"
    arc_size = struct.calcsize(arc_fmt)
    buf = _read(f, arc_size * numarcs)
    flat = [
        struct.unpack_from(arc_fmt, buf, i * arc_size) for i in range(numarcs)
    ]
    finals, arcs = [], []
    for final, pos, narcs in states:
        finals.append(final)
        arcs.append(
            [
                RawArc(r[0], r[1], tuple(r[2 : 2 + nfl]), r[2 + nfl])
                for r in flat[pos : pos + narcs]
            ]
        )
    return finals, arcs


def _write_const_body(f, raw: RawFst, aligned: bool) -> None:
    nfl, has_str = ARC_TYPES[raw.arctype]
    if has_str:
        raise ValueError("ConstFst cannot hold variable-size CompactLattice weights")
    if aligned:
        _align(f, write=True)
    st_fmt = "<" + "f" * nfl + "IIII"
    pos = 0
    for s in range(raw.num_states):
        sa = raw.arcs[s]
        neps_i = sum(1 for a in sa if a.ilabel == 0)
        neps_o = sum(1 for a in sa if a.olabel == 0)
        f.write(
            struct.pack(st_fmt, *raw.finals[s][:nfl], pos, len(sa), neps_i, neps_o)
        )
        pos += len(sa)
    if aligned:
        _align(f, write=True)
    arc_fmt = "<ii" + "f" * nfl + "i"
    for s in range(raw.num_states):
        for a in raw.arcs[s]:
            f.write(struct.pack(arc_fmt, a.ilabel, a.olabel, *a.weight[:nfl], a.nextstate))


# ---------------------------------------------------------------------------
# stream / file API
# ---------------------------------------------------------------------------


def read_fst_stream(f: BinaryIO, allow_stream_counts: bool = True) -> RawFst:
    """Read one OpenFst binary FST starting at the current position.

    `allow_stream_counts=False` rejects stream-written headers (negative
    state counts, whose body runs to EOF) — required inside multi-record
    archives, where a run-to-EOF body would silently swallow every
    subsequent record."""
    fsttype, arctype, version, flags, _props, start, numstates, numarcs = _read_header(f)
    if numstates < 0 and not allow_stream_counts:
        raise ValueError(
            "stream-written FST header (numstates < 0) inside an archive: "
            "the body runs to EOF and would consume all following records"
        )
    if arctype not in ARC_TYPES:
        raise ValueError(
            f"unsupported arc type {arctype!r}: expected one of {sorted(ARC_TYPES)}"
        )
    if flags & FLAG_HAS_ISYMBOLS:
        _skip_symbol_table(f)
    if flags & FLAG_HAS_OSYMBOLS:
        _skip_symbol_table(f)
    if fsttype == "vector":
        if version not in (1, VECTOR_FILE_VERSION):
            raise ValueError(f"unsupported VectorFst file version {version}")
        finals, arcs = _read_vector_body(f, arctype, numstates)
    elif fsttype == "const":
        if numstates < 0 or numarcs < 0:
            raise ValueError("ConstFst requires state/arc counts in the header")
        aligned = version == CONST_ALIGNED_FILE_VERSION or bool(flags & FLAG_IS_ALIGNED)
        finals, arcs = _read_const_body(f, arctype, numstates, numarcs, aligned)
    else:
        raise ValueError(
            f"unsupported fst type {fsttype!r}: expected 'vector' or 'const'"
        )
    return RawFst(fsttype=fsttype, arctype=arctype, start=start, finals=finals, arcs=arcs)


def write_fst_stream(
    f: BinaryIO,
    raw: RawFst,
    fsttype: str | None = None,
    aligned: bool = False,
) -> None:
    """Write `raw` in OpenFst binary format at the current position.

    State/arc counts are always written (VectorFst knows them up front;
    FstWriteOptions.stream_write in OpenFst only skips the header
    re-seek, not the counts — embedded archive reads depend on them).
    `aligned` applies to ConstFst only (version-1 aligned layout; alignment
    is relative to stream position, so use it for standalone files)."""
    fsttype = fsttype or raw.fsttype
    if fsttype == "vector":
        version, flags = VECTOR_FILE_VERSION, 0
    elif fsttype == "const":
        version = CONST_ALIGNED_FILE_VERSION if aligned else CONST_FILE_VERSION
        flags = FLAG_IS_ALIGNED if aligned else 0
    else:
        raise ValueError(f"unsupported fst type {fsttype!r}")
    numstates = raw.num_states
    numarcs = raw.num_arcs
    _write_header(
        f,
        fsttype,
        raw.arctype,
        version,
        flags,
        PROPS_EXPANDED | (PROPS_MUTABLE if fsttype == "vector" else 0),
        raw.start,
        numstates,
        numarcs,
    )
    if fsttype == "vector":
        _write_vector_body(f, raw)
    else:
        _write_const_body(f, raw, aligned)


def read_openfst_raw(path: str) -> RawFst:
    with open(path, "rb") as f:
        return read_fst_stream(f)


def write_openfst_raw(path: str, raw: RawFst, fsttype: str | None = None,
                      aligned: bool = False) -> None:
    with open(path, "wb") as f:
        write_fst_stream(f, raw, fsttype=fsttype, aligned=aligned)


# ---------------------------------------------------------------------------
# fstkit.Fst conversion (cost <-> log-prob sign flip)
# ---------------------------------------------------------------------------


def _weight_to_logprob(arctype: str, w) -> tuple[float, float]:
    """(weight, weight2) in fstkit convention: weight = total log-prob,
    weight2 = acoustic log-prob component (0 for single-component types)."""
    if arctype == "standard":
        return -w[0], 0.0
    g, a = w[0], w[1]
    return -(g + a), -a


def _weight_from_logprob(arctype: str, weight: float, weight2: float):
    if arctype == "standard":
        return (-weight,)
    g = -(weight - weight2)
    a = -weight2
    return (g, a, ()) if arctype == "compactlattice44" else (g, a)


def to_fstkit(raw: RawFst) -> tuple[Fst, list[int]]:
    """Convert to an fstkit acceptor over INPUT labels, returning per-arc
    OUTPUT labels aligned with `fst.all_arcs()` order (the convention
    graphs.hclg.make_hclg uses).  Acceptor files yield olabels == ilabels.

    State numbering is preserved except the start state is swapped to 0
    (fstkit fixes the start at state 0).  Infinite-cost (Zero-weight) arcs
    are preserved as -inf log-prob arcs."""
    if raw.start < 0:
        raise ValueError("FST has no start state")
    n = raw.num_states
    # swap start <-> 0
    perm = list(range(n))
    perm[0], perm[raw.start] = perm[raw.start], perm[0]
    ren = {old: new for new, old in enumerate(perm)}
    out = Fst()
    out.add_states(n)
    olabels: list[int] = []
    for old in perm:
        src = ren[old]
        for a in raw.arcs[old]:
            w, w2 = _weight_to_logprob(raw.arctype, a.weight)
            out.add_arc(src, a.ilabel, w, ren[a.nextstate], w2)
            olabels.append(a.olabel)
    for old in perm:
        if not _is_zero(raw.finals[old]):
            w, w2 = _weight_to_logprob(raw.arctype, raw.finals[old])
            out.set_final(ren[old], w, w2)
    return out, olabels


def from_fstkit(
    fst: Fst,
    arc_olabels: list[int] | None = None,
    arctype: str = "standard",
    arc_strings: list[tuple] | None = None,
) -> RawFst:
    """Convert an fstkit acceptor (+ optional per-arc output labels in
    `fst.all_arcs()` order) into a RawFst ready for write_fst_stream.
    `arc_strings` attaches CompactLattice transition-id alignments."""
    finals, arcs = [], []
    k = 0
    for s in range(fst.num_states):
        state_arcs = []
        for a in fst.arcs(s):
            w = _weight_from_logprob(arctype, a.weight, a.weight2)
            if arctype == "compactlattice44" and arc_strings is not None:
                w = (w[0], w[1], tuple(arc_strings[k]))
            ol = arc_olabels[k] if arc_olabels is not None else a.label
            state_arcs.append(RawArc(a.label, ol, w, a.dst))
            k += 1
        arcs.append(state_arcs)
        if fst.is_final(s):
            finals.append(_weight_from_logprob(arctype, fst.final(s), fst.final2(s)))
        else:
            finals.append(_zero_weight(arctype))
    return RawFst(fsttype="vector", arctype=arctype, start=0, finals=finals, arcs=arcs)


def read_openfst(path: str) -> tuple[Fst, list[int]]:
    """Read a binary OpenFst file into (fstkit.Fst over ilabels, per-arc
    olabels).  Covers den.fst / normalization.fst (acceptors) and HCLG.fst
    (transducer; olabels are word ids)."""
    return to_fstkit(read_openfst_raw(path))


def write_openfst(
    path: str,
    fst: Fst,
    arc_olabels: list[int] | None = None,
    arctype: str = "standard",
    fsttype: str = "vector",
    aligned: bool = False,
) -> None:
    """Write an fstkit acceptor as a binary OpenFst file (inverse of
    read_openfst)."""
    raw = from_fstkit(fst, arc_olabels, arctype=arctype)
    write_openfst_raw(path, raw, fsttype=fsttype, aligned=aligned)
