"""Kaldi binary stream primitives (kaldi/src/base/io-funcs.cc
conventions) shared by the binary-interchange modules (data/cegs.py,
graphs/transition_model.py, ...).

  * a record is `key ' ' \\x00B <object>`;
  * WriteToken emits `token + ' '`; WriteBasicType emits a size byte then
    the little-endian payload; bool is one byte 'T'/'F';
  * Vector<BaseFloat> bodies are `FV `/`DV ` + dim + raw data.

Dependency-free on purpose: importing this must never pull the data or
graphs packages (a graphs -> data -> graphs cycle shipped broken once;
tests/test_import_isolation.py guards every public module).
"""

from __future__ import annotations

import struct
from typing import BinaryIO

import numpy as np


def _read_exact(f: BinaryIO, n: int) -> bytes:
    b = f.read(n)
    if len(b) != n:
        raise ValueError(f"truncated Kaldi stream (wanted {n} bytes, got {len(b)})")
    return b


def expect_binary_marker(f: BinaryIO) -> None:
    m = f.read(2)
    if m != b"\x00B":
        raise ValueError(f"expected Kaldi binary marker \\x00B, got {m!r}")


def write_binary_marker(f: BinaryIO) -> None:
    f.write(b"\x00B")


def read_token(f: BinaryIO) -> str:
    tok = bytearray()
    ch = f.read(1)
    while ch not in (b" ", b""):
        tok.extend(ch)
        ch = f.read(1)
    if not tok:
        raise ValueError("empty token in Kaldi stream")
    return tok.decode()


def peek_token_first_char(f: BinaryIO) -> str:
    """Kaldi PeekToken semantics: first character of the next token with a
    leading '<' skipped (io-funcs.cc PeekToken)."""
    pos = f.tell()
    b = f.read(2)
    f.seek(pos)
    if not b:
        return ""
    if b[:1] == b"<" and len(b) > 1:
        return chr(b[1])
    return chr(b[0])


def expect_token(f: BinaryIO, token: str) -> None:
    got = read_token(f)
    if got != token:
        raise ValueError(f"expected token {token!r}, got {got!r}")


def write_token(f: BinaryIO, token: str) -> None:
    f.write(token.encode() + b" ")


def read_basic_int32(f: BinaryIO) -> int:
    sz = _read_exact(f, 1)
    if sz != b"\x04":
        raise ValueError(f"expected int32 size byte 4, got {sz!r}")
    return struct.unpack("<i", _read_exact(f, 4))[0]


def write_basic_int32(f: BinaryIO, v: int) -> None:
    f.write(b"\x04" + struct.pack("<i", v))


def read_basic_float(f: BinaryIO) -> float:
    sz = _read_exact(f, 1)
    if sz == b"\x04":
        return struct.unpack("<f", _read_exact(f, 4))[0]
    if sz == b"\x08":
        return struct.unpack("<d", _read_exact(f, 8))[0]
    raise ValueError(f"expected float size byte, got {sz!r}")


def write_basic_float(f: BinaryIO, v: float) -> None:
    f.write(b"\x04" + struct.pack("<f", v))


def read_basic_bool(f: BinaryIO) -> bool:
    ch = _read_exact(f, 1)
    if ch == b"T":
        return True
    if ch == b"F":
        return False
    raise ValueError(f"expected bool byte T/F, got {ch!r}")


def write_basic_bool(f: BinaryIO, v: bool) -> None:
    f.write(b"T" if v else b"F")


def read_integer_vector(f: BinaryIO) -> list[int]:
    """Kaldi ReadIntegerVector<int32>: size byte, raw int32 count, raw data."""
    sz = _read_exact(f, 1)
    if sz != b"\x04":
        raise ValueError(f"expected int32 size byte in integer vector, got {sz!r}")
    n = struct.unpack("<i", _read_exact(f, 4))[0]
    if n < 0 or n > 1_000_000_000:
        raise ValueError(f"implausible integer vector size {n}")
    return list(struct.unpack(f"<{n}i", _read_exact(f, 4 * n))) if n else []


def write_integer_vector(f: BinaryIO, v: list[int]) -> None:
    f.write(b"\x04" + struct.pack("<i", len(v)))
    if v:
        f.write(struct.pack(f"<{len(v)}i", *v))


def read_float_vector(f: BinaryIO) -> np.ndarray:
    """Vector<BaseFloat>::Read body (FV/DV token + dim + data)."""
    tok = read_token(f)
    if tok not in ("FV", "DV"):
        raise ValueError(f"expected FV/DV vector token, got {tok!r}")
    dim = read_basic_int32(f)
    width = 4 if tok == "FV" else 8
    dt = "<f4" if tok == "FV" else "<f8"
    return np.frombuffer(_read_exact(f, dim * width), dtype=dt).astype(np.float32)


def write_float_vector(f: BinaryIO, v: np.ndarray) -> None:
    v = np.asarray(v, dtype=np.float32)
    write_token(f, "FV")
    write_basic_int32(f, int(v.shape[0]))
    f.write(v.astype("<f4").tobytes())
