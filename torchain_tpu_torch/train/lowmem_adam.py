"""Adam with bfloat16-resident moments (torch), port of
torchain_tpu/train/lowmem_adam.py.

Both moments are stored in bfloat16, which halves the optimizer's moment
bytes; every step decodes them to float32, updates them in float32 and
encodes them again, so only the storage rounds.  The bias corrections are
float32 `1 - b^count`, as the JAX `update_fn` computes them, and the
update is optax's: step = (m / bc1) / (sqrt(v / bc2) + eps), scaled by
-lr and added to the parameter.

`LowmemAdam` is a `torch.optim.Optimizer`.  Its `state_dict` carries the
bfloat16 moments and the count; a resumed run is bit-equal to the uncut
one.  It is the checkpoint format of `train.chain_tx.ChainOptimizer`
(TrainerConfig(optimizer="adam-lowmem")), which computes the same update
on the device with its bias corrections from a device count.
"""

from __future__ import annotations

import numpy as np
import torch


def bias_corrections(count: int, b1: float, b2: float) -> tuple[float, float]:
    """float32 (1 - b1^count, 1 - b2^count)."""
    c = np.float32(count)
    one = np.float32(1.0)
    return (float(one - np.power(np.float32(b1), c)),
            float(one - np.power(np.float32(b2), c)))


def lowmem_adam_update(g: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor, count: int,
                       b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
    """One scale_by_adam_lowmem update of one tensor: (the update in g's
    dtype, the new mu and nu in their storage dtype).  `count` is the count
    after this update (1 on the first)."""
    bc1, bc2 = bias_corrections(count, b1, b2)
    g32 = g.float()
    m32 = b1 * mu.float() + (1.0 - b1) * g32
    v32 = b2 * nu.float() + (1.0 - b2) * torch.square(g32)
    step = (m32 / bc1) / (torch.sqrt(v32 / bc2) + eps)
    return step.to(g.dtype), m32.to(mu.dtype), v32.to(nu.dtype)


#: the dtype the moments are stored in
STATE_DTYPE = torch.bfloat16


class LowmemAdam(torch.optim.Optimizer):
    """Adam whose moments `mu` and `nu` are stored in bfloat16, with float32
    arithmetic."""

    def __init__(self, params, lr=1e-3, betas=(0.9, 0.999), eps=1e-8):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps, count=0))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            group["count"] += 1
            b1, b2 = group["betas"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                if not st:
                    st["mu"] = torch.zeros_like(p, dtype=STATE_DTYPE)
                    st["nu"] = torch.zeros_like(p, dtype=STATE_DTYPE)
                step, st["mu"], st["nu"] = lowmem_adam_update(
                    p.grad, st["mu"], st["nu"], group["count"], b1, b2, group["eps"])
                p.add_(step * -group["lr"])

    def load_state_dict(self, state_dict):
        # torch casts a loaded floating state to its parameter's dtype: the
        # moments go back to their storage dtype (their values are exact)
        super().load_state_dict(state_dict)
        for st in self.state.values():
            for k in ("mu", "nu"):
                if k in st:
                    st[k] = st[k].to(STATE_DTYPE)

    def state_bytes(self) -> int:
        """The bytes of the stored moments."""
        return sum(t.numel() * t.element_size() for st in self.state.values()
                   for t in st.values() if isinstance(t, torch.Tensor))
