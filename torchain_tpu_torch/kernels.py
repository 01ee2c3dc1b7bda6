"""Build and load the package's hand-written CUDA kernels.

Each `csrc/<name>.cu` (with the `csrc/*.cuh` it includes) has a plain C
interface and is compiled by `nvcc` for Hopper (`sm_90a`) into
`build/lib<name>.so`, then loaded with ctypes.  The build happens at first use, from the sources in this checkout, all sources
at once (one `nvcc` process each, started together).  Nothing here runs at
import time: the CPU-only test machine has neither `nvcc` nor a card.

A kernel entry point takes raw device pointers, sizes and the CUDA stream
(`torch.cuda.current_stream().cuda_stream`) and returns the
`cudaGetLastError()` of its launches; `check` turns a non-zero code into an
exception.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD = Path(__file__).resolve().parent / "build"

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong

#: C entry points per source: argument types (pointers and the stream as
#: c_void_p, sizes as c_int, element strides as c_longlong, scalars as
#: c_float); every one returns int (a CUDA error code, or for the
#: `*_shared_*`, `*_limit` and `*_per_block` queries a size)
SIGNATURES: dict[str, dict[str, list]] = {
    "den_resident": {
        # p, V, slot_pdf, init, sigma, ah, cpart, logc, T, B, P, S, K, leaky, stream
        "den_forward": [_P] * 8 + [_I] * 5 + [_F, _P],
        # p, ah, F, ymax, logz, V, slot_pdf, pdf_off, pdf_slot, init, bh, G,
        # vpart, gamma, T, B, P, S, K, splits, leaky, stream
        "den_backward": [_P] * 14 + [_I] * 6 + [_F, _P],
    },
    "num_vocab": {
        # y, vocab, out, B, T, P, W, stream
        "vocab_gather": [_P] * 3 + [_I] * 4 + [_P],
        # gsm, vocab, gamma, B, T, P, W, stream
        "vocab_scatter": [_P] * 3 + [_I] * 4 + [_P],
    },
    "num_resident": {
        # src, lpdf, logw, ysm, ysm strides (b, t), alpha1, out,
        # B, T-1, S, Kr, W, threads, stream
        "num_steady_forward": [_P] * 4 + [_L] * 2 + [_P] * 2 + [_I] * 6 + [_P],
        # src, lpdf, logw, ysm, ysm strides (b, t), alphas, final_logw, log_p,
        # gsm, beta1, B, T-1, S, Kr, W, threads, stream
        "num_steady_backward": [_P] * 4 + [_L] * 2 + [_P] * 5 + [_I] * 6 + [_P],
    },
    "num_e2e": {
        # ylocal, src, logw, nk, out, B, T, S, K, threads, stream
        "e2e_forward": [_P] * 5 + [_I] * 5 + [_P],
        # ylocal, alphas, src, logw, final_logw, log_p, by_off, by_arc, post,
        # B, T, S, K, L, threads, stream
        "e2e_backward": [_P] * 9 + [_I] * 6 + [_P],
        # the most dynamic shared memory a block may ask for, in bytes
        "e2e_shared_limit": [],
    },
    "den_dense": {
        # pe, V, orig_off, orig_exps, init, sigma, alpha, cpart, logc, sig,
        # T, B, S, E, leaky, stream
        "dense_den_forward": [_P] * 10 + [_I] * 4 + [_F, _P],
        # pe, V, orig_of_exp, init, sig, fscale, ymax, bh, G, sigma, vpart,
        # gout, T, B, S, E, real_exp, splits, leaky, stream
        "dense_den_backward": [_P] * 12 + [_I] * 6 + [_F, _P],
    },
    "probe_smem": {
        # x, out, KiB of dynamic shared memory, stream
        "probe_smem": [_P] * 2 + [_I, _P],
        # the device's opt-in limit per block, in bytes
        "probe_smem_limit": [],
    },
    "attention": {
        # qkv, bias, out, B, T, H, dh, scale, is_bf16, stream
        "attention_forward": [_P] * 3 + [_I] * 4 + [_F, _I, _P],
        # qkv, bias, g, dqkv, dl scratch, dbias, B, T, H, dh, scale, is_bf16, stream
        "attention_backward": [_P] * 6 + [_I] * 4 + [_F, _I, _P],
        # T, dh, backward -> bytes of shared memory per block; the device's limit
        "attention_shared_bytes": [_I] * 3,
        "attention_shared_limit": [],
    },
    "fused_ffn": {
        # xn, res, w1, b1, w2, b2, out, N, D, F, alpha, is_bf16, stream
        "ffn_forward": [_P] * 7 + [_I] * 3 + [_F, _I, _P],
        # xn, g, w1, b1, w2, dx, hbuf, dhbuf, db1_part, db2_part,
        # dw1, db1, dw2, db2, N, D, F, alpha, is_bf16, stream
        "ffn_backward": [_P] * 14 + [_I] * 3 + [_F, _I, _P],
        # rows per block; D, is_bf16, backward -> bytes per block; the limit
        "ffn_rows_per_block": [],
        "ffn_shared_bytes": [_I] * 3,
        "ffn_shared_limit": [],
    },
}

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_entries: dict[tuple[str, str], ctypes._CFuncPtr] = {}


#: where the CUDA toolkit puts nvcc when it is not on PATH
NVCC_DEFAULT = "/usr/local/cuda/bin/nvcc"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    if os.path.exists(NVCC_DEFAULT):
        return NVCC_DEFAULT
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path(name: str) -> Path:
    return BUILD / f"lib{name}.so"


def build(names=tuple(SIGNATURES), force: bool = False) -> float:
    """Compile the named sources (all by default) in parallel.  Sources
    whose library is newer than the source are skipped unless `force`.
    Writes each compiler log (register and shared-memory use from
    `-Xptxas -v`) beside the library.  Returns the wall seconds taken;
    raises with the compiler's output if any build fails."""
    BUILD.mkdir(parents=True, exist_ok=True)
    # a header (*.cuh) may be shared by several sources: a newer one makes
    # every library stale
    headers = max((h.stat().st_mtime for h in CSRC.glob("*.cuh")), default=0.0)
    todo = [
        n for n in names
        if force
        or not _lib_path(n).exists()
        or _lib_path(n).stat().st_mtime < max(headers, (CSRC / f"{n}.cu").stat().st_mtime)
    ]
    t0 = time.perf_counter()
    procs = []
    for n in todo:
        tmp = BUILD / f"lib{n}.so.tmp{os.getpid()}"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs.append((n, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
    failed = []
    for n, tmp, proc in procs:
        out, _ = proc.communicate()
        (BUILD / f"{n}.log").write_text(out)
        if proc.returncode != 0:
            failed.append(f"{n}.cu (exit {proc.returncode}):\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, _lib_path(n))
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, building it on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build((name,))
            lib = ctypes.CDLL(str(_lib_path(name)))
            for fn, argtypes in SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            lib.cuda_error_string.argtypes = [ctypes.c_int]
            lib.cuda_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def entry(name: str, fn: str):
    """The C entry point `fn` of `csrc/<name>.cu`, looked up once per
    process (a wrapper called every step then skips `library`'s lock)."""
    f = _entries.get((name, fn))
    if f is None:
        f = _entries[(name, fn)] = getattr(library(name), fn)
    return f


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a kernel entry point reported a CUDA error."""
    if err != 0:
        msg = lib.cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def check_tensor(name: str, x, dtype, shape=None) -> None:
    """Raise unless `x` is a contiguous CUDA tensor of `dtype` (and of
    `shape`, where given): what a kernel entry point takes."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {x.device}")
    if x.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if shape is not None and tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(x.shape)}")


def stream_of(device) -> int:
    """Raw handle of PyTorch's current CUDA stream on `device` (the call
    inductor's generated code makes: cheaper than `current_stream`, which
    builds a Stream object)."""
    import torch

    index = torch.cuda.current_device() if device.index is None else device.index
    return torch._C._cuda_getCurrentRawStream(index)
