"""io — Kaldi matrix archives (torchain `io.py` parity).

The reference's user-facing io module exposed an egs example reader and
per-utterance matrix writers (for posterior export to Kaldi decoding).
Here:

  * example reading  -> torchain_tpu_torch.data.ChainDataset /
                        E2eChainDataset (re-exported here), and
                        data.cegs.CegsDataset for merged Kaldi cegs archives
  * matrix writer    -> MatrixWriter: Kaldi TEXT ark format (readable by
                        copy-feats/latgen-faster-mapped ark,t: rspecifiers),
                        and write_ark_binary for binary FM/DM/CM archives,
                        so posteriors interoperate with Kaldi decoders

Host-side NumPy; a copy of torchain_tpu/io.py, writing the same bytes for
the same matrices.  Its device helper, `select_device`, checks a torch
device where the JAX one checked a JAX platform.
"""

from __future__ import annotations

import numpy as np

# ChainDataset / E2eChainDataset are re-exported lazily (module __getattr__
# below) rather than imported here: data.cegs imports the matrix codecs of
# this module, so reading an archive must not pull the loader and its graph
# compilers in with it.
_DATA_REEXPORTS = ("ChainDataset", "E2eChainDataset")


def __getattr__(name: str):
    if name in _DATA_REEXPORTS:
        from torchain_tpu_torch.data import loader

        return getattr(loader, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


#: JAX's platform names for the torch device types they stand for
_PLATFORM_ALIASES = {"gpu": "cuda"}


def select_device(platform: str | None = None):
    """The default torch device: the card (`cuda:0`) where one is present,
    else the CPU.  With `platform` ("cuda", its JAX name "gpu", or "cpu"),
    that platform's first device; a platform that is absent raises
    RuntimeError, as the JAX package's check does for a platform that is
    not its backend's.  (torchain's set_kaldi_device bound Kaldi to torch's
    GPU; the entry points' --device flags take this role.)"""
    import torch

    if platform is None:
        return torch.device("cuda:0" if torch.cuda.is_available() else "cpu")
    kind = _PLATFORM_ALIASES.get(platform, platform)
    if kind == "cpu":
        return torch.device("cpu")
    if kind == "cuda" and torch.cuda.is_available():
        return torch.device("cuda:0")
    default = "cuda" if torch.cuda.is_available() else "cpu"
    raise RuntimeError(
        f"requested platform {platform!r} but it is absent (the default device is "
        f"{default!r})"
    )

class MatrixWriter:
    """Write float matrices to a Kaldi TEXT archive (`ark,t:` format).

    Usage mirrors torchain's writer: `with MatrixWriter(path) as w:
    w[utt_id] = matrix`.  The output is consumable by Kaldi binaries via
    `ark,t:file`."""

    def __init__(self, path: str):
        self.path = path
        self._f = None

    def __enter__(self):
        self._f = open(self.path, "w")
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self):
        if self._f is not None:
            self._f.close()
            self._f = None

    def write(self, utt_id: str, matrix: np.ndarray) -> None:
        if self._f is None:
            self._f = open(self.path, "w")
        if " " in utt_id:
            raise ValueError("utterance ids must not contain spaces")
        mat = np.asarray(matrix, dtype=np.float32)
        if mat.ndim != 2:
            raise ValueError("expected a [T, D] matrix")
        self._f.write(f"{utt_id}  [\n")
        for row in mat:
            self._f.write("  " + " ".join(f"{x:.7g}" for x in row) + " \n")
        self._f.write("]\n")

    def __setitem__(self, utt_id: str, matrix: np.ndarray) -> None:
        self.write(utt_id, matrix)


def read_ark_text(path: str) -> dict[str, np.ndarray]:
    """Read a Kaldi text archive of float matrices (round-trip for
    MatrixWriter; also reads Kaldi-produced `ark,t` output)."""
    out: dict[str, np.ndarray] = {}
    utt = None
    rows: list[list[float]] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line.endswith("["):
                utt = line[:-1].strip()
                rows = []
            elif line.endswith("]"):
                body = line[:-1].strip()
                if body:
                    rows.append([float(x) for x in body.split()])
                if utt is None:
                    raise ValueError("malformed ark: ']' before any utterance")
                out[utt] = np.array(rows, dtype=np.float32)
                utt = None
            else:
                if utt is None:
                    raise ValueError(f"malformed ark line outside matrix: {line!r}")
                rows.append([float(x) for x in line.split()])
    if utt is not None:
        raise ValueError("malformed ark: unterminated matrix")
    return out


# ---------------------------------------------------------------------------
# Binary Kaldi archives
# ---------------------------------------------------------------------------
#
# Real Kaldi data dirs ship BINARY `feats.ark` (kaldi/src/matrix/
# kaldi-matrix.cc Write + compressed-matrix.cc); record layout:
#
#   <utt_id> \x00B <Token> <data>
#
# where Token is "FM " (float matrix), "DM " (double), "FV "/"DV "
# (vectors) or "CM " (CompressedMatrix format 1).  FM: two basic-size
# int32s (each prefixed by a \x04 size byte) for rows/cols, then row-major
# float32 data.  CM: a raw GlobalHeader {min f32, range f32, rows i32,
# cols i32}, per-column {p0, p25, p75, p100} uint16 quantile headers, then
# column-major uint8 codes decoded piecewise-linearly between the
# quantiles.

import struct as _struct


def _read_basic_int32(f) -> int:
    size = f.read(1)
    if size != b"\x04":
        raise ValueError(f"expected int32 size marker, got {size!r}")
    return _struct.unpack("<i", f.read(4))[0]


def _write_basic_int32(f, v: int) -> None:
    f.write(b"\x04" + _struct.pack("<i", v))


def _decode_cm1(f) -> np.ndarray:
    min_v, rng, rows, cols = _struct.unpack("<ffii", f.read(16))
    heads = np.frombuffer(f.read(8 * cols), dtype="<u2").reshape(cols, 4)
    data = np.frombuffer(f.read(rows * cols), dtype=np.uint8).reshape(cols, rows)
    p = min_v + rng * heads.astype(np.float64) / 65535.0  # [cols, 4]
    c = data.astype(np.float64)
    p0, p25, p75, p100 = (p[:, i : i + 1] for i in range(4))
    low = p0 + (p25 - p0) * (c / 64.0)
    mid = p25 + (p75 - p25) * ((c - 64.0) / 128.0)
    high = p75 + (p100 - p75) * ((c - 192.0) / 63.0)
    vals = np.where(c <= 64, low, np.where(c <= 192, mid, high))
    return vals.T.astype(np.float32)  # [rows, cols]


def _encode_cm1(f, mat: np.ndarray) -> None:
    mat = np.asarray(mat, dtype=np.float32)
    rows, cols = mat.shape
    min_v = float(mat.min()) if mat.size else 0.0
    max_v = float(mat.max()) if mat.size else 0.0
    rng = max(max_v - min_v, 1e-8)
    f.write(_struct.pack("<ffii", min_v, rng, rows, cols))

    def to_u16(x):
        return np.clip((x - min_v) / rng * 65535.0, 0, 65535).astype("<u2")

    qs = np.quantile(mat.astype(np.float64), [0.0, 0.25, 0.75, 1.0], axis=0).T
    heads = to_u16(qs)  # [cols, 4]
    # quantize the quantile boundaries exactly as the reader will see them
    pq = min_v + rng * heads.astype(np.float64) / 65535.0
    f.write(heads.astype("<u2").tobytes())
    codes = np.empty((cols, rows), dtype=np.uint8)
    for j in range(cols):
        x = mat[:, j].astype(np.float64)
        p0, p25, p75, p100 = pq[j]
        c_low = np.clip((x - p0) / max(p25 - p0, 1e-10) * 64.0 + 0.5, 0, 64)
        c_mid = np.clip((x - p25) / max(p75 - p25, 1e-10) * 128.0 + 64.5, 65, 192)
        c_high = np.clip((x - p75) / max(p100 - p75, 1e-10) * 63.0 + 192.5, 193, 255)
        codes[j] = np.where(
            x <= p25, c_low, np.where(x <= p75, c_mid, c_high)
        ).astype(np.uint8)
    f.write(codes.tobytes())


def _decode_cm23(f, per_elem_bytes: int) -> np.ndarray:
    """CompressedMatrix formats 2 (uint16) and 3 (uint8): global header then
    one linear code per element, row-major (kaldi/src/matrix/compressed-matrix.cc
    kTwoByte / kOneByte)."""
    min_v, rng, rows, cols = _struct.unpack("<ffii", f.read(16))
    dt = "<u2" if per_elem_bytes == 2 else np.uint8
    scale = 65535.0 if per_elem_bytes == 2 else 255.0
    data = np.frombuffer(f.read(rows * cols * per_elem_bytes), dtype=dt)
    vals = min_v + rng * data.astype(np.float64) / scale
    return vals.reshape(rows, cols).astype(np.float32)


def read_kaldi_matrix_binary(f) -> np.ndarray:
    """Read one Kaldi binary matrix/vector BODY (token + payload, no `\\x00B`
    marker) — FM/DM/FV/DV/CM/CM2/CM3.  This is the form nnet3 examples embed
    (GeneralMatrix::Write, kaldi/src/matrix/)."""
    token = bytearray()
    ch = f.read(1)
    while ch not in (b" ", b""):
        token.extend(ch)
        ch = f.read(1)
    tok = token.decode()
    if tok in ("FM", "DM"):
        rows = _read_basic_int32(f)
        cols = _read_basic_int32(f)
        dt = "<f4" if tok == "FM" else "<f8"
        n = rows * cols * (4 if tok == "FM" else 8)
        mat = np.frombuffer(f.read(n), dtype=dt).reshape(rows, cols)
        # DM keeps float64: CMVN stats (compute-cmvn-stats output) carry
        # frame counts + raw sums whose precision double exists to protect
        return mat.astype(np.float32 if tok == "FM" else np.float64)
    if tok in ("FV", "DV"):
        dim = _read_basic_int32(f)
        dt = "<f4" if tok == "FV" else "<f8"
        n = dim * (4 if tok == "FV" else 8)
        return np.frombuffer(f.read(n), dtype=dt).astype(
            np.float32 if tok == "FV" else np.float64
        )
    if tok == "CM":
        return _decode_cm1(f)
    if tok == "CM2":
        return _decode_cm23(f, 2)
    if tok == "CM3":
        return _decode_cm23(f, 1)
    raise ValueError(f"unsupported binary ark token {tok!r}")


def _read_binary_record(f) -> np.ndarray:
    """Read ONE binary record starting at the `\\x00B` marker (the byte a
    Kaldi scp offset points at) — FM/DM/FV/DV/CM/CM2/CM3."""
    marker = f.read(2)
    if marker != b"\x00B":
        raise ValueError(
            f"not a binary ark record (marker {marker!r}); "
            "use read_ark_text for ark,t archives"
        )
    return read_kaldi_matrix_binary(f)


def read_ark_key(f, what: str = "binary ark") -> str | None:
    """Read one archive record key (bytes until space); None at EOF.

    The shared scan for every binary-archive reader (feature arks, cegs,
    binary lattice arks) — one place to fix separator/truncation handling."""
    key = bytearray()
    ch = f.read(1)
    if not ch:
        return None
    while ch not in (b" ", b""):
        key.extend(ch)
        ch = f.read(1)
    if not key:
        raise ValueError(f"malformed {what}: empty record key")
    return key.decode()


def read_ark_binary(path: str) -> dict[str, np.ndarray]:
    """Read a binary Kaldi archive of float/double matrices, vectors, or
    compressed (CM) matrices.  FM/FV/CM records decode to float32; DM/DV
    keep float64 (CMVN stats carry frame counts + raw sums whose
    precision double exists to protect)."""
    out: dict[str, np.ndarray] = {}
    with open(path, "rb") as f:
        while True:
            utt = read_ark_key(f)
            if utt is None:
                break
            out[utt] = _read_binary_record(f)
    return out


def write_ark_binary(
    path: str,
    mats: dict[str, np.ndarray],
    compress: bool = False,
    scp_path: str | None = None,
) -> None:
    """Write float matrices as a binary Kaldi archive (FM, or CM compressed
    format 1 with `compress=True`; float64 input writes DM — the format
    `compute-cmvn-stats` emits) — what `copy-feats ark:... ark:...`
    produces.  With `scp_path`, also write the offset index (the
    `ark,scp:` dual-output form): lines `utt ark_path:offset` where the
    offset points at the record's `\\x00B` marker."""
    scp = open(scp_path, "w") if scp_path else None
    try:
        with open(path, "wb") as f:
            for utt, mat in mats.items():
                if " " in utt:
                    raise ValueError("utterance ids must not contain spaces")
                mat = np.asarray(mat)
                is_double = mat.dtype == np.float64
                mat = mat.astype(np.float64 if is_double else np.float32)
                if mat.ndim != 2:
                    raise ValueError("expected [T, D] matrices")
                f.write(utt.encode() + b" ")
                if scp is not None:
                    scp.write(f"{utt} {path}:{f.tell()}\n")
                f.write(b"\x00B")
                if compress:
                    f.write(b"CM ")
                    _encode_cm1(f, mat.astype(np.float32))
                else:
                    f.write(b"DM " if is_double else b"FM ")
                    _write_basic_int32(f, mat.shape[0])
                    _write_basic_int32(f, mat.shape[1])
                    f.write(mat.astype("<f8" if is_double else "<f4").tobytes())
    finally:
        if scp is not None:
            scp.close()


class ScpReader:
    """Random-access reader over a Kaldi `.scp` index (`utt path:offset`
    per line — the RandomAccessBaseFloatMatrixReader role).  Records are
    read lazily on [] access; `keys()` lists utterances without IO."""

    def __init__(self, scp_path: str):
        self.entries: dict[str, tuple[str, int]] = {}
        with open(scp_path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                utt, loc = line.split(None, 1)
                if ":" not in loc:
                    raise ValueError(f"scp line without offset: {line!r}")
                ark, off = loc.rsplit(":", 1)
                self.entries[utt] = (ark, int(off))

    def keys(self):
        return self.entries.keys()

    def __len__(self) -> int:
        return len(self.entries)

    def __contains__(self, utt: str) -> bool:
        return utt in self.entries

    def __getitem__(self, utt: str) -> np.ndarray:
        ark, off = self.entries[utt]
        with open(ark, "rb") as f:
            f.seek(off)
            return _read_binary_record(f)

    def items(self):
        """Iterate (utt, matrix) with ONE open per ark file, reading each
        ark's records in offset order (an scp over N utterances must not
        cost N open/seek/close cycles)."""
        by_ark: dict[str, list[tuple[int, str]]] = {}
        for utt, (ark, off) in self.entries.items():
            by_ark.setdefault(ark, []).append((off, utt))
        out: dict[str, np.ndarray] = {}
        for ark, offs in by_ark.items():
            with open(ark, "rb") as f:
                for off, utt in sorted(offs):
                    f.seek(off)
                    out[utt] = _read_binary_record(f)
        for utt in self.entries:  # preserve scp order
            yield utt, out[utt]


def read_scp(path: str) -> dict[str, np.ndarray]:
    """Eagerly read every record referenced by a Kaldi scp index."""
    return dict(ScpReader(path).items())


def read_rspecifier(rspec: str) -> dict[str, np.ndarray]:
    """Read a Kaldi-style rspecifier: `ark:path`, `ark,t:path`,
    `scp:path`, or a bare path (auto-detected)."""
    if ":" in rspec and rspec.split(":", 1)[0].replace(",", "").isalpha():
        kind, path = rspec.split(":", 1)
        kinds = set(kind.split(","))
        if "scp" in kinds:
            return read_scp(path)
        if "t" in kinds:
            return read_ark_text(path)
        if "ark" in kinds:
            return read_ark(path)
        raise ValueError(f"unsupported rspecifier {rspec!r}")
    return read_ark(rspec)


def read_ark(path: str) -> dict[str, np.ndarray]:
    """Auto-detect text vs binary Kaldi archives (the `\\x00B` marker after
    the first utterance id)."""
    with open(path, "rb") as f:
        head = f.read(4096)
    sp = head.find(b" ")
    if sp != -1 and head[sp + 1 : sp + 3] == b"\x00B":
        return read_ark_binary(path)
    return read_ark_text(path)
