"""The plain operations the reference trunks are written in: matrix
products at a chosen precision, batchnorm and layernorm in float32.

`Products("float32")` is the reference: float32 products with TF32 off
(the caller turns it off).  `Products("float8")` is the control, the next
precision below the trunk's bfloat16: each operand of a trunk product is
rounded to float8 e4m3 with a per-tensor scale (its largest magnitude to
448) on the way in, with the gradient passed straight through, as an fp8
training recipe rounds its forward products.
"""

from __future__ import annotations

import torch

FP8_MAX = 448.0


def _fp8(x: torch.Tensor) -> torch.Tensor:
    scale = FP8_MAX / torch.clamp(x.detach().abs().amax(), min=1e-30)
    q = (x.detach() * scale).to(torch.float8_e4m3fn).float() / scale
    return x + (q - x.detach())


class Products:
    """a @ b in float32, or with float8-rounded operands (module doc)."""

    def __init__(self, precision: str = "float32"):
        if precision not in ("float32", "float8"):
            raise ValueError(f"unknown precision {precision!r}")
        self.precision = precision

    def __call__(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.precision == "float8":
            a, b = _fp8(a), _fp8(b)
        return a @ b


def batchnorm(x: torch.Tensor, scale, bias, eps: float = 1e-5) -> torch.Tensor:
    """Training-mode batchnorm over every axis but the last: the batch's
    mean and biased variance."""
    dims = tuple(range(x.ndim - 1))
    mean = x.mean(dims)
    var = torch.clamp((x * x).mean(dims) - mean * mean, min=0.0)
    return (x - mean) * torch.rsqrt(var + eps) * scale + bias


def layernorm(x: torch.Tensor, scale, bias, eps: float = 1e-6) -> torch.Tensor:
    mean = x.mean(-1, keepdim=True)
    var = torch.clamp((x * x).mean(-1, keepdim=True) - mean * mean, min=0.0)
    return (x - mean) * torch.rsqrt(var + eps) * scale + bias


def swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def prefinal(p: dict, name: str, x: torch.Tensor, mm: Products) -> torch.Tensor:
    """Kaldi's prefinal-chain / prefinal-xent block: affine, relu,
    batchnorm, then the float32 affine to the pdfs (never rounded)."""
    h = torch.relu(mm(x, p[f"{name}.Dense_0.kernel"]) + p[f"{name}.Dense_0.bias"])
    h = batchnorm(h, p[f"{name}.BatchNorm_0.scale"], p[f"{name}.BatchNorm_0.bias"])
    return h @ p[f"{name}.Dense_1.kernel"] + p[f"{name}.Dense_1.bias"]
