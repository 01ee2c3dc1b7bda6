"""The initial parameters, made on the device from the seed in one call:
every matrix or tap kernel (two or more axes) normal with variance 1 /
fan-in (fan-in: every axis but the last), every scale 1, every bias 0.
Both sides start from these: the program's model is loaded with them and
the reference reads a copy."""

from __future__ import annotations

import math

import torch


def make_weights(shapes: dict, seed: int, device) -> dict:
    g = torch.Generator(device=device)
    g.manual_seed(seed % (1 << 63))
    kernels = [n for n, s in shapes.items() if len(s) >= 2]
    flat = torch.randn(sum(math.prod(shapes[n]) for n in kernels), generator=g,
                       device=device)
    out, off = {}, 0
    for name, shape in shapes.items():
        if len(shape) >= 2:
            k = math.prod(shape)
            out[name] = flat[off:off + k].view(shape) / math.sqrt(math.prod(shape[:-1]))
            off += k
        elif name.endswith("scale"):
            out[name] = torch.ones(shape, device=device)
        else:
            out[name] = torch.zeros(shape, device=device)
    return out
