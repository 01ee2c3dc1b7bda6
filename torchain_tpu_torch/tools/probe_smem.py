"""Probe the shared memory one thread block can really use on the attached
GPU, with kernel T1: a block that pins N KiB of dynamic shared memory,
writes 2x to its first words and 3x to its last, and returns their sum.
Prints PASS/FAIL per size and the largest size that ran.

Usage: python -m torchain_tpu_torch.tools.probe_smem [sizes_kib...]

Port of tools/probe_vmem.py, which probes the TPU's on-chip memory the same
way.  Nothing reads a saved budget here: the kernel wrappers that need the
limit ask the device for it.
"""

from __future__ import annotations

import sys

import torch

from torchain_tpu_torch import kernels

#: sizes tried by default, KiB: below and above the 48 KiB a block gets
#: without opting in, up to and past Hopper's 227 KiB
DEFAULT_SIZES_KIB = (16, 48, 64, 100, 128, 164, 200, 227, 228, 256)

LANES = 128


def try_size_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain T1: what the probe returns when it runs, 2x + 3x."""
    return 5.0 * x


def try_size(x: torch.Tensor, kib: int) -> torch.Tensor:
    """T1.  x: 128 float32 values.  Returns 2x + 3x computed through a
    block's first and last shared-memory words, `kib` KiB apart; raises
    RuntimeError when the device refuses that much shared memory.  Launches
    csrc/probe_smem.cu:probe_smem on a CUDA tensor."""
    if kib < 1:
        raise ValueError("the probe needs at least 1 KiB")
    if x.device.type == "cpu":
        return try_size_plain(x)
    kernels.check_tensor("x", x, torch.float32, (LANES,))
    out = torch.empty_like(x)
    lib = kernels.library("probe_smem")
    err = lib.probe_smem(x.data_ptr(), out.data_ptr(), int(kib), kernels.stream_of(x.device))
    kernels.check(lib, err, f"probe_smem({kib} KiB)")
    try_size.launches += 1
    return out


try_size.launches = 0


def largest(sizes_kib=DEFAULT_SIZES_KIB, device="cuda", log=print) -> int:
    """Try the sizes in rising order until one fails; returns the largest
    that ran and gave 5x (0 if none did)."""
    x = torch.arange(1, LANES + 1, dtype=torch.float32, device=device)
    best = 0
    for kib in sorted(sizes_kib):
        try:
            out = try_size(x, kib)
            if x.is_cuda:
                torch.cuda.synchronize()  # a fault during the run shows here
            ok = bool(torch.equal(out, try_size_plain(x)))
        except RuntimeError as e:
            log(f"  error: {str(e)[:300]}")
            ok = False
        log(f"shared memory {kib} KiB: {'PASS' if ok else 'FAIL'}")
        if not ok:
            break
        best = kib
    return best


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    sizes = [int(s) for s in args] or DEFAULT_SIZES_KIB
    if not torch.cuda.is_available():
        print("probe_smem: no CUDA device", file=sys.stderr)
        return 2
    limit = kernels.library("probe_smem").probe_smem_limit()
    print(f"device={torch.cuda.get_device_name(0)} opt-in limit per block: {limit} bytes",
          flush=True)
    best = largest(sizes)
    print(f"largest: {best} KiB", flush=True)
    return 0 if best else 1


if __name__ == "__main__":
    sys.exit(main())
