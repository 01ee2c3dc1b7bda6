"""Adam (Kingma and Ba 2015), float32, bias-corrected:

    m <- b1 m + (1 - b1) g;  v <- b2 v + (1 - b2) g^2
    d = (m / (1 - b1^c)) / (sqrt(v / (1 - b2^c)) + eps)      (c: this update's count)
"""

from __future__ import annotations

import torch

B1, B2, EPS = 0.9, 0.999, 1e-8


class Rule:
    def __init__(self, params: list, recipe: dict):
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]

    @torch.no_grad()
    def direction(self, grads: list, count: int) -> list:
        c1, c2 = 1 - B1 ** count, 1 - B2 ** count
        out = []
        for g, m, v in zip(grads, self.m, self.v):
            m.mul_(B1).add_(g, alpha=1 - B1)
            v.mul_(B2).addcmul_(g, g, value=1 - B2)
            out.append((m / c1) / (torch.sqrt(v / c2) + EPS))
        return out
