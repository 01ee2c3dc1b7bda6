"""ctypes bridge to the native decoder (csrc/decoder.cc), port of
torchain_tpu/eval/native.py.

The host side of the decode path: a flat C ABI over packed arrays, loaded
with ctypes.  `get_lib` builds the package's own copy of the source,
`csrc/decoder.cc`, with the host C++ compiler into the git-ignored
`build/` beside it (`g++ -O3 -march=native -fPIC -std=c++17 -shared`), at
first use and again whenever the source is newer than the library.  The
compiler writes to a name of its own process and the result is renamed
into place, so several processes may build at once.

Where no C++ compiler is found, `get_lib` returns None (and says so once
on stderr); the decoders' `backend="auto"` then runs their NumPy
reference.  A compiler that fails, or a library that does not load,
raises with the compiler's output: it never falls quietly to NumPy.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np

from torchain_tpu_torch.fstkit.fst import NEG_INF, Arc, Fst

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "decoder.cc"
BUILD = Path(__file__).resolve().parent.parent / "build"
LIBRARY = BUILD / "libdecoder.so"
CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-shared")

_lock = threading.Lock()
_lib = None
_no_compiler = False


def _compiler() -> str | None:
    return shutil.which("g++") or shutil.which("c++")


def _stale() -> bool:
    return not LIBRARY.exists() or LIBRARY.stat().st_mtime < SOURCE.stat().st_mtime


def build(force: bool = False) -> bool:
    """Compile `csrc/decoder.cc` into `build/libdecoder.so` unless the
    library is newer than the source (or `force`).  Returns False where
    no C++ compiler is found; raises with the compiler's output where it
    fails."""
    if not force and not _stale():
        return True
    cxx = _compiler()
    if cxx is None:
        return False
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = BUILD / f"{LIBRARY.name}.tmp{os.getpid()}"
    proc = subprocess.run(
        [cxx, *CXXFLAGS, "-o", str(tmp), str(SOURCE)],
        capture_output=True, text=True, timeout=300,
    )
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"{cxx} failed to build {SOURCE.name} (exit {proc.returncode}):\n"
            f"{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, LIBRARY)
    return True


def _declare(lib) -> None:
    """Argument and return types of every entry point."""
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    c_i32p = ctypes.POINTER(ctypes.c_int32)
    i, f = ctypes.c_int, ctypes.c_float
    out = [i32p, ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_float)]
    protos = {
        "tt_viterbi_decode": (ctypes.c_int, [
            i, i, i, i, i32p, i32p, i32p, f32p, i32p, f32p, f32p, f, i, *out,
        ]),
        "tt_viterbi_decode_active": (ctypes.c_int, [
            i, i, i, i, i32p, i32p, i32p, f32p, i32p, f32p, f32p, f, i, i, *out,
        ]),
        "tt_viterbi_decode_eps": (ctypes.c_int, [
            i, i, i, i, i32p, i32p, i32p, f32p, i32p, f32p,
            i, i32p, i32p, f32p, i32p,
            f32p, f, i, i, i, *out,
        ]),
        "tt_lattice_decode": (ctypes.c_void_p, [
            i, i, i, i, i32p, i32p, i32p, f32p, i32p, f32p,
            i32p, i32p, i32p, f32p, i32p,
            f32p, f, i, i, c_i32p, c_i32p, c_i32p, c_i32p,
        ]),
        "tt_lattice_decode_eps": (ctypes.c_void_p, [
            i, i, i, i, i32p, i32p, i32p, f32p, i32p, f32p,
            i32p, i32p, i32p, f32p, i32p,
            i, i32p, i32p, f32p, i32p,
            f32p, f, i, i, c_i32p, c_i32p, c_i32p, c_i32p,
        ]),
        "tt_lattice_fetch": (ctypes.c_int, [
            ctypes.c_void_p, i32p, i32p, i32p, f32p, f32p, i32p, f32p,
        ]),
        "tt_lattice_fetch_times": (ctypes.c_int, [ctypes.c_void_p, i32p]),
        "tt_lattice_free": (None, [ctypes.c_void_p]),
        "tt_lattice_arrays_best_path": (ctypes.c_int, [
            ctypes.c_int32, ctypes.c_int32, i32p, i32p, i32p, f32p,
            ctypes.c_int32, i32p, f32p,
            i32p, ctypes.c_int32, ctypes.POINTER(ctypes.c_double),
        ]),
    }
    for name, (restype, argtypes) in protos.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes


def get_lib():
    """The loaded native library, built on first use; None only where no
    C++ compiler is found (said once on stderr).  Raises where the build
    or the load fails."""
    global _lib, _no_compiler
    if _lib is not None or _no_compiler:
        return _lib
    with _lock:
        if _lib is None and not _no_compiler:
            if not build():
                _no_compiler = True
                print(
                    "[native] no C++ compiler found: decoding runs the NumPy "
                    "reference (backend='auto')",
                    file=sys.stderr,
                )
                return None
            lib = ctypes.CDLL(str(LIBRARY))
            _declare(lib)
            _lib = lib
    return _lib


def native_viterbi(graph, loglikes: np.ndarray, beam: float, use_final: bool):
    """Returns (phones, score), or None where the library is missing or
    the core reports a failure."""
    lib = get_lib()
    if lib is None:
        return None
    T = loglikes.shape[0]
    out_phones = np.zeros(T, dtype=np.int32)
    out_len = ctypes.c_int32(0)
    out_score = ctypes.c_float(0.0)
    rc = lib.tt_viterbi_decode(
        graph.num_states,
        graph.src.shape[0],
        graph.num_pdfs,
        T,
        np.ascontiguousarray(graph.src, np.int32),
        np.ascontiguousarray(graph.dst, np.int32),
        np.ascontiguousarray(graph.pdf, np.int32),
        np.ascontiguousarray(graph.weight, np.float32),
        np.ascontiguousarray(graph.olabel, np.int32),
        np.ascontiguousarray(graph.final_logw, np.float32),
        np.ascontiguousarray(loglikes, np.float32),
        beam,
        int(use_final),
        out_phones,
        ctypes.byref(out_len),
        ctypes.byref(out_score),
    )
    if rc != 0:
        return None
    return [int(p) for p in out_phones[: out_len.value]], float(out_score.value)


def _src_csr(graph):
    """Cached src-sorted arc views (offsets, dst, pdf, weight, olabel).

    Within each source state's block, arcs are ordered by DESCENDING
    weight: the C cores bound a candidate by ts + weight + ll_max and
    BREAK at the first arc that cannot reach the beam cutoff, which turns
    the 20k+-fanout LM backoff states (the enumeration wall at real HCLG
    scale) into a few dozen touched arcs per token."""
    cached = getattr(graph, "_src_csr_cache", None)
    if cached is not None:
        return cached
    order = np.lexsort((-graph.weight, graph.src))
    src_sorted = np.ascontiguousarray(graph.src[order], np.int32)
    offsets = np.zeros(graph.num_states + 1, dtype=np.int32)
    np.add.at(offsets, src_sorted + 1, 1)
    np.cumsum(offsets, out=offsets)
    cached = (
        offsets.astype(np.int32),
        np.ascontiguousarray(graph.dst[order], np.int32),
        np.ascontiguousarray(graph.pdf[order], np.int32),
        np.ascontiguousarray(graph.weight[order], np.float32),
        np.ascontiguousarray(graph.olabel[order], np.int32),
    )
    try:
        object.__setattr__(graph, "_src_csr_cache", cached)
    except Exception:
        pass
    return cached


def _dst_csr(graph):
    """Cached contiguous dst-sorted views (offsets, src, pdf, weight,
    olabel) — the graph's own packing order; the native lattice emission
    walks survivors' IN-arcs through these (see csrc/decoder.cc)."""
    cached = getattr(graph, "_dst_csr_cache", None)
    if cached is not None:
        return cached
    cached = (
        np.ascontiguousarray(graph.dst_offsets, np.int32),
        np.ascontiguousarray(graph.src, np.int32),
        np.ascontiguousarray(graph.pdf, np.int32),
        np.ascontiguousarray(graph.weight, np.float32),
        np.ascontiguousarray(graph.olabel, np.int32),
    )
    try:
        object.__setattr__(graph, "_dst_csr_cache", cached)
    except Exception:
        pass
    return cached


def _eps_arrays(graph):
    """Contiguous level-sorted eps arc arrays (see decoder._pack_eps_arcs)."""
    return (
        np.ascontiguousarray(graph.eps_src, np.int32),
        np.ascontiguousarray(graph.eps_dst, np.int32),
        np.ascontiguousarray(graph.eps_weight, np.float32),
        np.ascontiguousarray(graph.eps_olabel, np.int32),
    )


def native_viterbi_active(
    graph,
    loglikes: np.ndarray,
    beam: float,
    max_active: int,
    use_final: bool,
):
    """Active-token best path (faster-decoder role: only live states are
    expanded, max_active caps the frontier).  Handles graphs with
    input-epsilon arcs (real Kaldi HCLGs) through tt_viterbi_decode_eps.
    Returns (phones, score), or None where the library is missing or the
    core reports a failure.  (A best path through the lattice generator
    would emit and trim the survivor-arc set only to read one backpointer
    chain; the dedicated per-survivor record core avoids that.)"""
    lib = get_lib()
    if lib is None:
        return None
    if getattr(graph, "num_eps", 0):
        return _native_viterbi_eps(lib, graph, loglikes, beam, max_active, use_final)
    offsets, dst, pdf, weight, olabel = _src_csr(graph)
    T = loglikes.shape[0]
    out_phones = np.zeros(T, dtype=np.int32)
    out_len = ctypes.c_int32(0)
    out_score = ctypes.c_float(0.0)
    rc = lib.tt_viterbi_decode_active(
        graph.num_states,
        dst.shape[0],
        graph.num_pdfs,
        T,
        offsets, dst, pdf, weight, olabel,
        np.ascontiguousarray(graph.final_logw, np.float32),
        np.ascontiguousarray(loglikes, np.float32),
        beam,
        int(max_active),
        int(use_final),
        out_phones,
        ctypes.byref(out_len),
        ctypes.byref(out_score),
    )
    if rc != 0:
        return None
    return [int(p) for p in out_phones[: out_len.value]], float(out_score.value)


def _native_viterbi_eps(lib, graph, loglikes, beam, max_active, use_final):
    offsets, dst, pdf, weight, olabel = _src_csr(graph)
    esrc, edst, ew, eol = _eps_arrays(graph)
    T = loglikes.shape[0]
    # a path can emit a word on an eps arc at every boundary and level
    capacity = T + (T + 1) * max(len(graph.eps_levels) - 1, 0)
    out_phones = np.zeros(capacity, dtype=np.int32)
    out_len = ctypes.c_int32(0)
    out_score = ctypes.c_float(0.0)
    rc = lib.tt_viterbi_decode_eps(
        graph.num_states,
        dst.shape[0],
        graph.num_pdfs,
        T,
        offsets, dst, pdf, weight, olabel,
        np.ascontiguousarray(graph.final_logw, np.float32),
        graph.num_eps, esrc, edst, ew, eol,
        np.ascontiguousarray(loglikes, np.float32),
        beam,
        int(max_active),
        int(use_final),
        capacity,
        out_phones,
        ctypes.byref(out_len),
        ctypes.byref(out_score),
    )
    if rc != 0:
        return None
    return [int(p) for p in out_phones[: out_len.value]], float(out_score.value)


class NativeLattice(Fst):
    """Lattice Fst whose Python ``Arc`` lists materialize lazily from the
    native decoder's raw arrays.  The hot consumers — ``lattice_best_path``
    (native/vectorized DP over ``_lattice_arrays``), ``num_states``,
    ``num_arcs`` — never touch per-arc Python objects, so a best-path
    decode skips the construction cost entirely; anything that iterates arcs (nbest, MBR, determinize, ark writers)
    triggers a one-time materialization and behaves exactly as before.

    ``_arcs`` is a read-only property backed by ``_arcs_cache``; the
    materialized lists are mutable, so ``add_state``/``add_arc`` keep
    working after the first access."""

    def __init__(
        self, n_states, arc_src, arc_dst, arc_ol, arc_w, arc_am,
        fin_s, fin_w,
    ):
        self._raw_arcs = (arc_src, arc_dst, arc_ol, arc_w, arc_am)
        self._arcs_cache = None
        self._final = [NEG_INF] * n_states
        self._final2 = [0.0] * n_states
        for s, w in zip(
            fin_s.tolist(), np.asarray(fin_w, np.float64).tolist()
        ):
            self._final[s] = w

    @property
    def _arcs(self):
        if self._arcs_cache is None:
            arcs: list[list] = [[] for _ in range(len(self._final))]
            src, dst, ol, w, am = self._raw_arcs
            asrc = src.tolist()
            for i, a in enumerate(
                map(Arc, ol.tolist(), w.tolist(), dst.tolist(), am.tolist())
            ):
                arcs[asrc[i]].append(a)
            self._arcs_cache = arcs
        return self._arcs_cache

    @property
    def num_states(self) -> int:
        return len(self._final)

    @property
    def num_arcs(self) -> int:
        if self._arcs_cache is None:
            return int(self._raw_arcs[0].shape[0])
        return sum(len(a) for a in self._arcs_cache)


def native_lattice_best_path(lat):
    """Best path over a NativeLattice's raw arrays via the C sweep
    (tt_lattice_arrays_best_path); returns (labels, score) or None when
    the library/arrays are unavailable.  Valid for eps lattices too —
    the arc list is emitted in topological order."""
    arrays = getattr(lat, "_lattice_arrays", None)
    if arrays is None:
        return None
    lib = get_lib()
    if lib is None:
        return None
    src, dst, ol, w, fin_s, fin_w, _times = arrays
    L = int(lat.num_states)
    cap = L + 1
    out = np.empty(cap, np.int32)
    score = ctypes.c_double(0.0)
    n = lib.tt_lattice_arrays_best_path(
        L, src.shape[0], src, dst, ol, w,
        fin_s.shape[0], fin_s, fin_w, out, cap, ctypes.byref(score),
    )
    if n < 0:
        return None
    return out[:n].tolist(), float(score.value)


def native_lattice(
    graph,
    loglikes: np.ndarray,
    beam: float,
    max_active: int = 0,
    use_final: bool = True,
    phone_bonus: float = 0.0,
):
    """Active-token lattice generation (latgen-faster-mapped role).

    Returns an fstkit.Fst with the same contents as the numpy
    lattice_decode under equal beams (plus Kaldi's max_active frontier
    cap, which numpy doesn't implement), or None if the native library is
    missing."""
    lib = get_lib()
    if lib is None:
        return None
    offsets, dst, pdf, weight, olabel = _src_csr(graph)
    dofs, dsrc, dpdf, dweight, dolabel = _dst_csr(graph)
    num_eps = int(getattr(graph, "num_eps", 0))
    if phone_bonus != 0.0:
        weight = (weight + phone_bonus * (olabel > 0)).astype(np.float32)
        dweight = (dweight + phone_bonus * (dolabel > 0)).astype(np.float32)
    T = loglikes.shape[0]
    n_states = ctypes.c_int32(0)
    n_arcs = ctypes.c_int32(0)
    n_finals = ctypes.c_int32(0)
    err = ctypes.c_int32(0)
    if num_eps:
        esrc, edst, ew, eol = _eps_arrays(graph)
        if phone_bonus != 0.0:
            ew = (ew + phone_bonus * (eol > 0)).astype(np.float32)
        handle = lib.tt_lattice_decode_eps(
            graph.num_states,
            dst.shape[0],
            graph.num_pdfs,
            T,
            offsets, dst, pdf, weight, olabel,
            np.ascontiguousarray(graph.final_logw, np.float32),
            dofs, dsrc, dpdf, dweight, dolabel,
            num_eps, esrc, edst, ew, eol,
            np.ascontiguousarray(loglikes, np.float32),
            beam,
            int(max_active),
            int(use_final),
            ctypes.byref(n_states),
            ctypes.byref(n_arcs),
            ctypes.byref(n_finals),
            ctypes.byref(err),
        )
    else:
        handle = lib.tt_lattice_decode(
            graph.num_states,
            dst.shape[0],
            graph.num_pdfs,
            T,
            offsets, dst, pdf, weight, olabel,
            np.ascontiguousarray(graph.final_logw, np.float32),
            dofs, dsrc, dpdf, dweight, dolabel,
            np.ascontiguousarray(loglikes, np.float32),
            beam,
            int(max_active),
            int(use_final),
            ctypes.byref(n_states),
            ctypes.byref(n_arcs),
            ctypes.byref(n_finals),
            ctypes.byref(err),
        )
    if not handle:
        if err.value == 2:
            raise ValueError("all decoding tokens died (beam too small?)")
        return None
    try:
        NA, NF = n_arcs.value, n_finals.value
        arc_src = np.empty(NA, np.int32)
        arc_dst = np.empty(NA, np.int32)
        arc_ol = np.empty(NA, np.int32)
        arc_w = np.empty(NA, np.float32)
        arc_am = np.empty(NA, np.float32)
        fin_s = np.empty(NF, np.int32)
        fin_w = np.empty(NF, np.float32)
        rc = lib.tt_lattice_fetch(
            handle, arc_src, arc_dst, arc_ol, arc_w, arc_am, fin_s, fin_w
        )
        if rc != 0:
            return None
        state_times = None
        times = np.empty(int(n_states.value), np.int32)
        if lib.tt_lattice_fetch_times(handle, times) != 0:
            times = None
        if num_eps:
            if times is None:
                return None
            state_times = [int(t) for t in times]
    finally:
        lib.tt_lattice_free(handle)
    fst = NativeLattice(
        int(n_states.value), arc_src, arc_dst, arc_ol, arc_w, arc_am,
        fin_s, fin_w,
    )
    if state_times is not None:
        fst.state_times = state_times
    # raw arrays for the vectorized/native best-path fast paths
    # (eval/lattice.lattice_best_path); the numpy boundary-batched DP is
    # only valid when every arc crosses a frame boundary, so eps lattices
    # are flagged (the C sweep handles both — arcs are topologically
    # ordered either way)
    if times is not None:
        fst._lattice_arrays = (
            arc_src, arc_dst, arc_ol, arc_w, fin_s, fin_w, times
        )
        fst._eps_arrays = bool(num_eps)
    return fst
