"""nnet3 acoustic-model import: the nnet body of a Kaldi `final.mdl` (a copy
of torchain_tpu/graphs/nnet3.py, which imports no JAX).

Behavioral reference: [K] nnet3/nnet-nnet.cc (Nnet::Read/Write:
``<Nnet3>`` + TEXT config lines embedded in the binary stream +
``<NumComponents>`` + per-component blocks), [K] nnet3/am-nnet-simple.cc
(AmNnetSimple::Write: nnet, then <LeftContext> <RightContext> <Priors>),
[K] nnet3/nnet-simple-component.cc + nnet-convolutional-component.cc
(component field layouts).

Purpose (SURVEY §2.2 surrounding ecosystem; VERDICT r4 missing #3): a
real Kaldi chain system ships its trained acoustic model inside
`final.mdl` after the TransitionModel.  Importing it enables the
strongest offline parity check available on first real contact —
per-frame posterior comparison against Kaldi's own nnet3-compute — and
warm-starting.  `read_am_nnet` parses the model, `Nnet.forward` evaluates
it in numpy (inference mode) on the host: an import and cross-check path,
not a trunk.  The JAX package's `tools/crosscheck_kaldi.py --mdl --forward`
drives the comparison; the port has no counterpart of that tool yet.

Component coverage: the common chain TDNN / TDNN-F recipe set —
(NaturalGradient)AffineComponent, LinearComponent, TdnnComponent
(factored TDNN-F with internal TimeOffsets), FixedAffineComponent (LDA),
RectifiedLinearComponent, BatchNormComponent (test-mode stats),
LogSoftmaxComponent, NoOpComponent, dropout/backprop-truncation
identities.  Unknown components still PARSE (fields are skipped by their
self-describing binary framing) so a model inspects cleanly; forwarding
through one raises with the component type named.

Provenance caveat (as with every binary-interchange module here): the
reference mount is empty, so the layout is pinned by self-written golden
fixtures plus an independently-coded numpy forward in the tests; on
first contact with a real Kaldi system run the JAX package's
``tools/crosscheck_kaldi.py --mdl final.mdl --forward feats.ark``.
"""

from __future__ import annotations

import dataclasses
import re
import struct
from typing import BinaryIO

import numpy as np

from torchain_tpu_torch.utils.kaldi_io import (
    expect_token,
    read_basic_int32,
    read_token,
    write_basic_int32,
    write_token,
)

# ---------------------------------------------------------------------------
# low-level binary fields
# ---------------------------------------------------------------------------

#: fields whose \x04 payload is an int32 (everything else 4-byte decodes
#: as float32); \x08 payloads decode as float64 unless listed int64
_INT_FIELDS = {
    "Dim", "BlockDim", "InputDim", "OutputDim", "RankIn", "RankOut",
    "UpdatePeriod", "InputVectorization", "NumRepeats", "NumBlocks",
    "LeftContext", "RightContext",
}
#: fields written with WriteIntegerVector (\x04 + count + count*int32)
_INTVEC_FIELDS = {"TimeOffsets", "Context", "ColumnMap", "Sizes"}


def _read_float_or_double_vector(f: BinaryIO) -> np.ndarray:
    tok = read_token(f)
    if tok not in ("FV", "DV"):
        raise ValueError(f"expected FV/DV, got {tok!r}")
    dim = read_basic_int32(f)
    dt, w = ("<f4", 4) if tok == "FV" else ("<f8", 8)
    return np.frombuffer(f.read(dim * w), dtype=dt).astype(np.float32)


def _read_matrix(f: BinaryIO) -> np.ndarray:
    tok = read_token(f)
    if tok not in ("FM", "DM"):
        raise ValueError(f"expected FM/DM, got {tok!r}")
    rows = read_basic_int32(f)
    cols = read_basic_int32(f)
    dt, w = ("<f4", 4) if tok == "FM" else ("<f8", 8)
    m = np.frombuffer(f.read(rows * cols * w), dtype=dt)
    return m.reshape(rows, cols).astype(np.float32)


def _write_fm(f: BinaryIO, m: np.ndarray) -> None:
    m = np.asarray(m, np.float32)
    write_token(f, "FM")
    write_basic_int32(f, int(m.shape[0]))
    write_basic_int32(f, int(m.shape[1]))
    f.write(m.astype("<f4").tobytes())


def _write_fv(f: BinaryIO, v: np.ndarray) -> None:
    v = np.asarray(v, np.float32)
    write_token(f, "FV")
    write_basic_int32(f, int(v.shape[0]))
    f.write(v.astype("<f4").tobytes())


def _read_field_value(f: BinaryIO, key: str):
    """Read one component field payload by its self-describing framing.

    Handles: FM/DM matrices, FV/DV vectors, bool chars, \x04/\x08 basic
    types (int-vs-float disambiguated by the known-fields table),
    WriteIntegerVector for known vector fields, and valueless flags
    (next byte already '<')."""
    pos = f.tell()
    b0 = f.read(1)
    if not b0:
        raise EOFError(f"EOF reading field {key!r}")
    if b0 in (b"F", b"D"):
        b1 = f.read(1)
        f.seek(pos)
        if b1 in (b"M",):
            return _read_matrix(f)
        if b1 in (b"V",):
            return _read_float_or_double_vector(f)
        if b0 == b"F":  # bool false (single char, no space)
            f.read(1)
            return False
        raise ValueError(f"cannot parse field {key!r} starting {b0 + b1!r}")
    if b0 == b"T":
        return True
    if b0 == b"\x04":
        if key in _INTVEC_FIELDS:
            (n,) = struct.unpack("<i", f.read(4))
            return list(
                struct.unpack(f"<{n}i", f.read(4 * n))
            )
        raw = f.read(4)
        if key in _INT_FIELDS:
            return int(struct.unpack("<i", raw)[0])
        return float(struct.unpack("<f", raw)[0])
    if b0 == b"\x08":
        raw = f.read(8)
        return float(struct.unpack("<d", raw)[0])
    if b0 == b"<":  # valueless flag token follows immediately
        f.seek(pos)
        return None
    raise ValueError(f"cannot parse field {key!r} starting {b0!r}")


def _write_field_value(f: BinaryIO, key: str, val) -> None:
    if isinstance(val, bool):
        f.write(b"T" if val else b"F")
    elif isinstance(val, np.ndarray) and val.ndim == 2:
        _write_fm(f, val)
    elif isinstance(val, np.ndarray):
        _write_fv(f, val)
    elif isinstance(val, list):
        f.write(b"\x04" + struct.pack("<i", len(val)))
        f.write(struct.pack(f"<{len(val)}i", *val))
    elif isinstance(val, int) and key in _INT_FIELDS:
        f.write(b"\x04" + struct.pack("<i", val))
    elif key in ("Count",):  # doubles in the reference layout
        f.write(b"\x08" + struct.pack("<d", float(val)))
    else:
        f.write(b"\x04" + struct.pack("<f", float(val)))


# ---------------------------------------------------------------------------
# components
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Component:
    """One nnet3 component: type tag + parsed fields (matrices as numpy)."""

    name: str
    type: str
    attrs: dict

    # -- forward (inference mode) -----------------------------------------

    _AFFINE = {
        "NaturalGradientAffineComponent",
        "AffineComponent",
        "FixedAffineComponent",
    }
    _LINEAR = {"LinearComponent", "NaturalGradientLinearComponent"}
    _IDENTITY = {
        "NoOpComponent",
        "GeneralDropoutComponent",
        "DropoutComponent",
        "BackpropTruncationComponent",
    }

    @property
    def time_offsets(self) -> list[int]:
        """Input time offsets this component consumes per output frame
        (TdnnComponent folds its context in-component)."""
        if self.type == "TdnnComponent":
            return list(self.attrs.get("TimeOffsets", [0]))
        return [0]

    def forward(self, x: np.ndarray) -> np.ndarray:
        """x [T, in_dim] -> [T, out_dim].  For TdnnComponent, in_dim is
        len(TimeOffsets) * input-dim (rows already appended in offset
        order, matching Kaldi's PrecomputedIndexes ordering)."""
        t = self.type
        a = self.attrs
        if t in self._AFFINE:
            return x @ a["LinearParams"].T + a["BiasParams"]
        if t in self._LINEAR:
            return x @ a["Params"].T
        if t == "TdnnComponent":
            y = x @ a["LinearParams"].T
            if a.get("BiasParams") is not None and np.size(
                a.get("BiasParams")
            ):
                y = y + a["BiasParams"]
            return y
        if t == "RectifiedLinearComponent":
            return np.maximum(x, 0.0)
        if t == "BatchNormComponent":
            # test-mode forward from accumulated stats
            # ([K] nnet-normalize-component.cc ComputeDerived):
            # scale = target-rms / sqrt(var + eps); offset = -mean*scale
            count = max(float(a.get("Count", 0.0)), 1e-10)
            mean = a["StatsMean"] / 1.0
            var = a["StatsVar"]
            # Kaldi stores raw sums in some versions; normalized stats in
            # others — the writer here stores normalized mean/var
            eps = float(a.get("Epsilon", 1e-3))
            rms = float(a.get("TargetRms", 1.0))
            scale = rms / np.sqrt(var + eps)
            return (x - mean) * scale
        if t == "LogSoftmaxComponent":
            m = x.max(axis=-1, keepdims=True)
            s = np.exp(x - m).sum(axis=-1, keepdims=True)
            return x - m - np.log(s)
        if t in self._IDENTITY:
            return x
        raise NotImplementedError(
            f"forward not implemented for nnet3 component type {t!r} "
            f"(component {self.name!r}); parsed fields: "
            f"{sorted(self.attrs)}"
        )

    @property
    def output_dim(self) -> int | None:
        a = self.attrs
        if "LinearParams" in a:
            return int(a["LinearParams"].shape[0])
        if "Params" in a:
            return int(a["Params"].shape[0])
        if "Dim" in a:
            return int(a["Dim"])
        return None


def _read_component(f: BinaryIO) -> Component:
    expect_token(f, "<ComponentName>")
    name = read_token(f)
    type_tok = read_token(f)
    if not (type_tok.startswith("<") and type_tok.endswith(">")):
        raise ValueError(f"expected component type token, got {type_tok!r}")
    ctype = type_tok[1:-1]
    close = f"</{ctype}>"
    attrs: dict = {}
    while True:
        tok = read_token(f)
        if tok == close:
            break
        if not (tok.startswith("<") and tok.endswith(">")):
            raise ValueError(
                f"unexpected token {tok!r} inside component {name!r}"
            )
        key = tok[1:-1].lstrip("/")
        val = _read_field_value(f, key)
        if val is not None:
            attrs[key] = val
    return Component(name=name, type=ctype, attrs=attrs)


def _write_component(f: BinaryIO, c: Component) -> None:
    write_token(f, "<ComponentName>")
    write_token(f, c.name)
    write_token(f, f"<{c.type}>")
    for key, val in c.attrs.items():
        write_token(f, f"<{key}>")
        _write_field_value(f, key, val)
    write_token(f, f"</{c.type}>")


# ---------------------------------------------------------------------------
# descriptors ([K] nnet3/nnet-descriptor.h grammar, the subset chain
# recipes use)
# ---------------------------------------------------------------------------


def _split_args(s: str) -> list[str]:
    """Split a descriptor argument list on top-level commas."""
    out, depth, cur = [], 0, []
    for ch in s:
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
        if ch == "," and depth == 0:
            out.append("".join(cur).strip())
            cur = []
        else:
            cur.append(ch)
    if cur:
        out.append("".join(cur).strip())
    return out


@dataclasses.dataclass
class Desc:
    op: str  # ref|append|sum|scale|const|offset|replace_t|round|ifdef
    args: tuple = ()

    @staticmethod
    def parse(s: str) -> "Desc":
        s = s.strip()
        m = re.match(r"^([A-Za-z]+)\((.*)\)$", s, re.S)
        if not m:
            return Desc("ref", (s,))
        fn, body = m.group(1), m.group(2)
        parts = _split_args(body)
        if fn == "Append":
            return Desc("append", tuple(Desc.parse(p) for p in parts))
        if fn == "Sum":
            return Desc("sum", tuple(Desc.parse(p) for p in parts))
        if fn == "Offset":
            return Desc("offset", (Desc.parse(parts[0]), int(parts[1])))
        if fn == "Scale":
            return Desc("scale", (float(parts[0]), Desc.parse(parts[1])))
        if fn == "Const":
            return Desc("const", (float(parts[0]), int(parts[1])))
        if fn == "ReplaceIndex":
            return Desc(
                "replace_t", (Desc.parse(parts[0]), parts[1], int(parts[2]))
            )
        if fn == "Round":
            return Desc("round", (Desc.parse(parts[0]), int(parts[1])))
        if fn == "IfDefined":
            return Desc("ifdef", (Desc.parse(parts[0]),))
        if fn == "Failover":
            return Desc("ifdef", (Desc.parse(parts[0]),))  # first branch
        raise ValueError(f"unsupported descriptor function {fn!r}")

    def to_string(self) -> str:
        if self.op == "ref":
            return self.args[0]
        if self.op == "append":
            return "Append(" + ", ".join(a.to_string() for a in self.args) + ")"
        if self.op == "sum":
            return "Sum(" + ", ".join(a.to_string() for a in self.args) + ")"
        if self.op == "offset":
            return f"Offset({self.args[0].to_string()}, {self.args[1]})"
        if self.op == "scale":
            return f"Scale({self.args[0]}, {self.args[1].to_string()})"
        if self.op == "const":
            return f"Const({self.args[0]}, {self.args[1]})"
        if self.op == "replace_t":
            return (
                f"ReplaceIndex({self.args[0].to_string()}, {self.args[1]}, "
                f"{self.args[2]})"
            )
        if self.op == "round":
            return f"Round({self.args[0].to_string()}, {self.args[1]})"
        if self.op == "ifdef":
            return f"IfDefined({self.args[0].to_string()})"
        raise ValueError(self.op)


# ---------------------------------------------------------------------------
# the nnet
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Node:
    kind: str  # input|component|output|dim-range
    name: str
    dim: int = 0
    component: str = ""
    input: "Desc | None" = None
    objective: str = "linear"
    dim_offset: int = 0
    src: str = ""  # dim-range source node


@dataclasses.dataclass
class Nnet:
    nodes: dict  # name -> Node (insertion-ordered)
    components: dict  # name -> Component

    # -- config (text) -----------------------------------------------------

    @staticmethod
    def _parse_config_line(line: str) -> "Node | None":
        line = line.strip()
        if not line or line.startswith("#"):
            return None
        kind, rest = (line.split(None, 1) + [""])[:2]
        # key=value pairs; a value may contain spaces/commas inside
        # arbitrarily nested parentheses — scan with a depth counter
        fields = {}
        i, n = 0, len(rest)
        while i < n:
            while i < n and rest[i].isspace():
                i += 1
            eq = rest.find("=", i)
            if eq < 0:
                break
            key = rest[i:eq].strip()
            j = eq + 1
            depth = 0
            while j < n and (depth > 0 or not rest[j].isspace()):
                if rest[j] == "(":
                    depth += 1
                elif rest[j] == ")":
                    depth -= 1
                j += 1
            fields[key] = rest[eq + 1 : j]
            i = j
        if kind == "input-node":
            return Node("input", fields["name"], dim=int(fields["dim"]))
        if kind == "component-node":
            return Node(
                "component",
                fields["name"],
                component=fields["component"],
                input=Desc.parse(fields["input"]),
            )
        if kind == "output-node":
            return Node(
                "output",
                fields["name"],
                input=Desc.parse(fields["input"]),
                objective=fields.get("objective", "linear"),
            )
        if kind == "dim-range-node":
            return Node(
                "dim-range",
                fields["name"],
                dim=int(fields["dim"]),
                dim_offset=int(fields["dim-offset"]),
                src=fields["input-node"],
            )
        raise ValueError(f"unsupported nnet3 config line kind {kind!r}")

    def config_lines(self) -> list[str]:
        out = []
        for n in self.nodes.values():
            if n.kind == "input":
                out.append(f"input-node name={n.name} dim={n.dim}")
            elif n.kind == "component":
                out.append(
                    f"component-node name={n.name} component={n.component} "
                    f"input={n.input.to_string().replace(', ', ',')}"
                )
            elif n.kind == "output":
                obj = (
                    f" objective={n.objective}"
                    if n.objective != "linear"
                    else ""
                )
                out.append(
                    f"output-node name={n.name} "
                    f"input={n.input.to_string().replace(', ', ',')}{obj}"
                )
            elif n.kind == "dim-range":
                out.append(
                    f"dim-range-node name={n.name} input-node={n.src} "
                    f"dim-offset={n.dim_offset} dim={n.dim}"
                )
        return out

    # -- binary IO ([K] nnet-nnet.cc Write/Read) ---------------------------

    def write_binary(self, f: BinaryIO) -> None:
        write_token(f, "<Nnet3>")
        f.write(b"\n")
        for line in self.config_lines():
            f.write(line.encode() + b"\n")
        f.write(b"\n")  # blank line terminates the config section
        write_token(f, "<NumComponents>")
        write_basic_int32(f, len(self.components))
        for c in self.components.values():
            _write_component(f, c)
        write_token(f, "</Nnet3>")

    @classmethod
    def read_binary(cls, f: BinaryIO) -> "Nnet":
        expect_token(f, "<Nnet3>")
        # config section: text lines up to a blank line
        line = f.readline()  # remainder of the <Nnet3> line
        nodes: dict = {}
        while True:
            line = f.readline()
            if not line:
                raise EOFError("EOF inside nnet3 config section")
            text = line.decode().strip()
            if not text:
                break
            node = cls._parse_config_line(text)
            if node is not None:
                nodes[node.name] = node
        expect_token(f, "<NumComponents>")
        n = read_basic_int32(f)
        components: dict = {}
        for _ in range(n):
            c = _read_component(f)
            components[c.name] = c
        expect_token(f, "</Nnet3>")
        return cls(nodes=nodes, components=components)

    # -- evaluation --------------------------------------------------------

    def forward(
        self,
        inputs: dict,
        t: np.ndarray,
        output: str = "output",
    ) -> np.ndarray:
        """Evaluate `output` at input-frame indexes `t` (chain models:
        multiples of the frame-subsampling factor).

        `inputs` maps input-node names to [T, dim] arrays indexed by
        absolute frame (e.g. {"input": feats, "ivector": ivecs}).  Frame
        indexes outside [0, T) clamp to the edge (the same
        edge-replication the data loader uses for acoustic context);
        pass feats with real context to avoid it."""
        t = np.asarray(t, dtype=np.int64)
        cache: dict = {}

        def node_at(name: str, tt: np.ndarray) -> np.ndarray:
            key = (name, tt.tobytes())
            if key in cache:
                return cache[key]
            node = self.nodes.get(name)
            if node is None:
                raise KeyError(f"nnet3 node {name!r} not found")
            if node.kind == "input":
                x = inputs[name]
                idx = np.clip(tt, 0, x.shape[0] - 1)
                out = np.asarray(x)[idx]
            elif node.kind == "dim-range":
                base = node_at(node.src, tt)
                out = base[:, node.dim_offset : node.dim_offset + node.dim]
            elif node.kind == "component":
                comp = self.components[node.component]
                offs = comp.time_offsets
                parts = [eval_desc(node.input, tt + o) for o in offs]
                x = np.concatenate(parts, axis=1) if len(parts) > 1 else parts[0]
                out = comp.forward(x)
            elif node.kind == "output":
                out = eval_desc(node.input, tt)
            else:
                raise ValueError(node.kind)
            cache[key] = out
            return out

        def eval_desc(d: Desc, tt: np.ndarray) -> np.ndarray:
            if d.op == "ref":
                return node_at(d.args[0], tt)
            if d.op == "append":
                return np.concatenate(
                    [eval_desc(a, tt) for a in d.args], axis=1
                )
            if d.op == "sum":
                parts = [eval_desc(a, tt) for a in d.args]
                out = parts[0]
                for p in parts[1:]:
                    out = out + p
                return out
            if d.op == "offset":
                return eval_desc(d.args[0], tt + d.args[1])
            if d.op == "scale":
                return d.args[0] * eval_desc(d.args[1], tt)
            if d.op == "const":
                return np.full((len(tt), d.args[1]), d.args[0], np.float32)
            if d.op == "replace_t":
                return eval_desc(
                    d.args[0], np.full_like(tt, d.args[2])
                )
            if d.op == "round":
                m = d.args[1]
                return eval_desc(d.args[0], (tt // m) * m)
            if d.op == "ifdef":
                return eval_desc(d.args[0], tt)
            raise ValueError(d.op)

        return node_at(output, t)

    def describe(self) -> str:
        """Human-readable summary (nnet3-info role)."""
        lines = [f"num-nodes: {len(self.nodes)}",
                 f"num-components: {len(self.components)}"]
        n_params = 0
        for c in self.components.values():
            p = sum(
                int(np.size(v))
                for k, v in c.attrs.items()
                if isinstance(v, np.ndarray)
                and k in ("LinearParams", "BiasParams", "Params")
            )
            n_params += p
            lines.append(f"  component {c.name} type={c.type} params={p}")
        lines.insert(2, f"num-parameters: {n_params}")
        return "\n".join(lines)


@dataclasses.dataclass
class AmNnet:
    """AmNnetSimple payload: nnet + context + priors
    ([K] nnet3/am-nnet-simple.cc Write — no enclosing tokens)."""

    nnet: Nnet
    left_context: int = 0
    right_context: int = 0
    priors: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.float32)
    )

    def write_binary(self, f: BinaryIO) -> None:
        self.nnet.write_binary(f)
        write_token(f, "<LeftContext>")
        write_basic_int32(f, self.left_context)
        write_token(f, "<RightContext>")
        write_basic_int32(f, self.right_context)
        write_token(f, "<Priors>")
        _write_fv(f, self.priors)

    @classmethod
    def read_binary(cls, f: BinaryIO) -> "AmNnet":
        nnet = Nnet.read_binary(f)
        expect_token(f, "<LeftContext>")
        left = read_basic_int32(f)
        expect_token(f, "<RightContext>")
        right = read_basic_int32(f)
        expect_token(f, "<Priors>")
        priors = _read_float_or_double_vector(f)
        return cls(
            nnet=nnet, left_context=left, right_context=right, priors=priors
        )


def read_am_nnet(path: str):
    """Read (TransitionModel, AmNnet) from a binary Kaldi model file —
    the full `final.mdl` contract ([K] nnet3/am-nnet-simple.h +
    nnet3bin/nnet3-am-copy.cc read path).  The TransitionModel-only
    reader (graphs.transition_model.read_transition_model) stays the
    cheap path when the nnet is not needed."""
    from torchain_tpu_torch.graphs.transition_model import TransitionModel
    from torchain_tpu_torch.utils.kaldi_io import expect_binary_marker

    with open(path, "rb") as f:
        head = f.read(2)
        f.seek(0)
        if head != b"\x00B":
            raise ValueError(
                f"{path}: text-mode .mdl with nnet body not supported; "
                "convert with nnet3-am-copy --binary=true"
            )
        expect_binary_marker(f)
        tm = TransitionModel.read_binary(f)
        am = AmNnet.read_binary(f)
    return tm, am


def write_am_nnet(path: str, tm, am: AmNnet) -> None:
    from torchain_tpu_torch.utils.kaldi_io import write_binary_marker

    with open(path, "wb") as f:
        write_binary_marker(f)
        tm.write_binary(f)
        am.write_binary(f)
