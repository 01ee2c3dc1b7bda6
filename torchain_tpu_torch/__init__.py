"""torchain_tpu_torch — LF-MMI (chain) training in PyTorch with hand-written
CUDA kernels for the NVIDIA H100.

The port of the JAX package `torchain_tpu` (which stays the reference).
Its module layout mirrors that package; it imports nothing from it.
Entry points take an explicit `device` (default "cuda"); a CPU tensor runs
each kernel's plain PyTorch version instead, which is what the tests use.
The CUDA sources in `csrc/` are compiled by nvcc at first use
(`kernels.py`).
"""

__all__ = ["cli", "convert", "data", "fstkit", "graphs", "io", "kernels", "models", "ops", "train", "utils"]
