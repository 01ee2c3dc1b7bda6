"""The optimizer chain of the JAX package's Trainer (torch), port of
torchain_tpu/train/trainer.py `make_optimizer` and `max_change`:

    MultiSteps(k)( clip_by_global_norm -> adam | adam-lowmem | sgd(momentum)
                   | natural_gradient -> sgd(momentum), at an exponentially
                   decaying learning rate -> max_change )

computed as optax computes it, with every tensor a step reads on the
parameters' device, as the JAX package's one jitted step does: the update
count and the micro-step are device scalars, the learning rate and Adam's
float32 bias corrections 1 - b**count are computed from the count on the
device (optax's `scale_by_schedule`), the moments, traces, covariances and
the accumulated gradient are tensors made at construction and written in
place.  No step reads a device value on the host, so the same steps run
eagerly or captured as CUDA graphs (`train.captured`; `Trainer(
TrainerConfig(capture=True))`).  What differs from step to step is known
on the host: `plan(passes)` names the kind of each of the next optimizer
calls ("accumulate", "update", or for NG-SGD "refresh", an update that also
recomputes the damped inverses), `apply(kind, scale)` runs one on the
device and `advance(kinds)` moves the host's counters; `step(scale)` does
all three.  The update is optax's: the inner transform's update u (-lr
times Adam's step or the trace), max-change on u, then p += scale * u.
"""

from __future__ import annotations

import numpy as np
import torch

from torchain_tpu_torch.parallel.sharding import gather_leaf_value, shard_of, squared_norms
from torchain_tpu_torch.train.lowmem_adam import STATE_DTYPE, LowmemAdam
from torchain_tpu_torch.train.ngsgd import NGSGD, precondition_
from torchain_tpu_torch.train.step import clip_by_global_norm_, global_norm

#: Adam's and adam-lowmem's constants (optax's defaults)
B1, B2, EPS = 0.9, 0.999, 1e-8


def lr_schedule(cfg):
    """count -> learning rate: optax.exponential_decay(lr, lr_decay_steps,
    lr_final / lr, end_value=lr_final) where both are set, else constant;
    evaluated in float32 at the count of updates made before this one, as
    optax's scale_by_schedule does."""
    if not (cfg.lr_final > 0.0 and cfg.lr_decay_steps > 0):
        return lambda count: cfg.lr
    lr, rate = np.float32(cfg.lr), np.float32(cfg.lr_final / cfg.lr)
    steps, end = np.float32(cfg.lr_decay_steps), np.float32(cfg.lr_final)

    def schedule(count: int) -> float:
        if count <= 0:
            return float(lr)
        value = lr * np.power(rate, np.float32(count) / steps)
        return float(max(value, end) if rate < 1 else min(value, end))

    return schedule


def max_change(per_component: float = 0.75, global_change: float = 2.0):
    """Kaldi max-change update clipping (every chain recipe trains with
    per-component max-change 0.75 and --trainer.max-param-change 2.0):
    each component's parameter DELTA (post-LR) is rescaled to 2-norm <=
    per_component, then the whole update so that its global 2-norm <=
    global_change.  Unlike gradient clipping this bounds the parameters'
    actual motion per step.  Returns updates -> updates over a list of
    tensors (the last transform of the optimizer chain)."""

    def apply(updates: list[torch.Tensor], params=None) -> list[torch.Tensor]:
        # `params`: the updates' parameters, where leaves sharded over the
        # model axis take their norms over the model group
        if per_component > 0:
            norms = [torch.sqrt(sq) for sq in squared_norms(updates, params)]
            updates = [u * torch.clamp(per_component / torch.clamp(n, min=1e-30), max=1.0)
                       for u, n in zip(updates, norms)]
        if global_change > 0:
            g = global_norm(updates, params)
            scale = torch.clamp(global_change / torch.clamp(g, min=1e-30), max=1.0)
            updates = [u * scale for u in updates]
        return updates

    return apply


class ChainOptimizer:
    """The JAX package's optax chain (module doc) with its whole state on
    the parameters' device.  `step(scale)` consumes the parameters' .grad:
    with k > 1 the gradient is folded into a running mean (optax's Welford
    form) and the update runs on every k-th call only, on the mean; the
    schedule's count advances once per update.  Max-change and the
    backstitch `scale` act on the update itself.

    `inner` is the torch optimizer of the same rule (torch.optim.Adam or
    SGD, `train.lowmem_adam.LowmemAdam`, `train.ngsgd.NGSGD`).  It is never
    stepped: its `state_dict` is the checkpoint format (the moments under
    torch's names), and NGSGD's options and initial covariances come from
    it.  A restore copies into the existing tensors, so a graph captured
    over them stays valid."""

    #: `train.captured.check_capturable` takes it
    capturable = True

    def __init__(self, params, cfg):
        self.params = [p for p in params if p.requires_grad]
        if cfg.optimizer == "adam":
            self.inner = torch.optim.Adam(self.params, lr=cfg.lr, betas=(B1, B2), eps=EPS)
        elif cfg.optimizer == "adam-lowmem":
            self.inner = LowmemAdam(self.params, lr=cfg.lr)
        elif cfg.optimizer == "sgd":
            self.inner = torch.optim.SGD(self.params, lr=cfg.lr, momentum=cfg.momentum)
        elif cfg.optimizer == "ngsgd":
            self.inner = NGSGD(self.params, lr=cfg.lr, momentum=cfg.momentum)
        else:
            raise ValueError(f"optimizer {cfg.optimizer!r} is not ported (the optimizers are:"
                             " adam, adam-lowmem, sgd, ngsgd)")
        self.schedule = lr_schedule(cfg)
        self.grad_clip = cfg.grad_clip
        self.every = max(1, cfg.grad_accum_steps)
        self.max_change = (
            max_change(cfg.max_change_per_component, cfg.max_param_change)
            if cfg.max_change_per_component > 0 or cfg.max_param_change > 0 else None)
        #: updates made and the micro-step, on the host
        self.count = 0
        self.mini_step = 0
        self.kind = cfg.optimizer
        self.momentum = cfg.momentum
        self.lr = cfg.lr
        self.decay = ((cfg.lr_final / cfg.lr, float(cfg.lr_decay_steps), cfg.lr_final)
                      if cfg.lr_final > 0.0 and cfg.lr_decay_steps > 0 else None)
        ps = self.params
        dev = ps[0].device
        #: the same two counters on the device
        self.count_t = torch.zeros((), dtype=torch.int32, device=dev)
        self.mini_t = torch.zeros((), dtype=torch.int32, device=dev)
        self.acc = [torch.zeros_like(p) for p in ps] if self.every > 1 else None
        self.moments = self.trace = self.sides = None
        if self.kind == "adam":
            self.moments = ([torch.zeros_like(p) for p in ps], [torch.zeros_like(p) for p in ps])
        elif self.kind == "adam-lowmem":
            self.moments = tuple([torch.zeros_like(p, dtype=STATE_DTYPE) for p in ps]
                                 for _ in range(2))
        elif self.momentum != 0.0:
            self.trace = [torch.zeros_like(p) for p in ps]
        if self.kind == "ngsgd":
            # the covariances and inverses NGSGD made (identities), ours now
            self.sides = [dict(self.inner.state.pop(p, {})) for p in ps]

    # -- the host's side ----------------------------------------------------

    def plan(self, passes: int = 1) -> tuple[str, ...]:
        """The kinds of the next `passes` optimizer calls: "accumulate" (a
        micro-step that only folds its gradient into the mean), "update",
        or "refresh" (NG-SGD's update that recomputes its inverses)."""
        kinds, mini, count = [], self.mini_step, self.count
        for _ in range(passes):
            if mini != self.every - 1:
                kinds.append("accumulate")
                mini += 1
                continue
            mini, count = 0, count + 1
            period = self.inner.opts.inverse_period if self.kind == "ngsgd" else 0
            kinds.append("refresh" if period and count % period == 0 else "update")
        return tuple(kinds)

    def advance(self, kinds) -> None:
        """Move the host's counters past calls of `kinds` (`plan`'s)."""
        for kind in kinds:
            if kind == "accumulate":
                self.mini_step += 1
            else:
                self.mini_step, self.count = 0, self.count + 1

    def step(self, scale: float = 1.0) -> bool:
        (kind,) = self.plan(1)
        self.apply(kind, scale)
        self.advance((kind,))
        return kind != "accumulate"

    def state_bytes(self) -> int:
        """The bytes of the update rule's state: the moments, the momentum
        traces and NG-SGD's covariances and inverses."""
        return sum(t.numel() * t.element_size() for i in range(len(self.params))
                   for t, _ in self._slots(i))

    def tensors(self) -> list[torch.Tensor]:
        """Every tensor of the chain's state (for a snapshot)."""
        out = [self.count_t, self.mini_t, *(self.acc or ())]
        for group in (*(self.moments or ()), self.trace or ()):
            out.extend(group)
        for sides in self.sides or ():
            out.extend(sides.values())
        return out

    # -- the device's side --------------------------------------------------

    def _lr(self):
        """The learning rate at the updates made so far: a float, or with a
        decay a float32 device scalar (optax.exponential_decay)."""
        if self.decay is None:
            return self.lr
        rate, steps, end = self.decay
        c = self.count_t.float()
        value = self.lr * torch.pow(rate, c / steps)
        value = torch.clamp(value, min=end) if rate < 1 else torch.clamp(value, max=end)
        return torch.where(c <= 0, self.lr, value)

    def _bias_corrections(self):
        """float32 (1 - b1**count, 1 - b2**count) at the count after this
        update, as optax computes them."""
        c = self.count_t.float()
        return 1 - torch.pow(B1, c), 1 - torch.pow(B2, c)

    def _inner_update(self, grads, refresh: bool) -> list[torch.Tensor]:
        """The inner transform's update -lr * step for each gradient; moves
        the count and the inner state."""
        neg_lr = -self._lr()
        self.count_t.add_(1)
        if self.kind == "adam":
            mu, nu = self.moments
            torch._foreach_mul_(mu, B1)
            torch._foreach_add_(mu, grads, alpha=1 - B1)
            torch._foreach_mul_(nu, B2)
            torch._foreach_addcmul_(nu, grads, grads, value=1 - B2)
            bc1, bc2 = self._bias_corrections()
            den = torch._foreach_div(nu, bc2)
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, EPS)
            ups = torch._foreach_div(mu, bc1)
            torch._foreach_div_(ups, den)
        elif self.kind == "adam-lowmem":
            bc1, bc2 = self._bias_corrections()
            ups = []
            for g, m, v in zip(grads, *self.moments):
                g32 = g.float()
                m32 = B1 * m.float() + (1.0 - B1) * g32
                v32 = B2 * v.float() + (1.0 - B2) * torch.square(g32)
                ups.append(((m32 / bc1) / (torch.sqrt(v32 / bc2) + EPS)).to(g.dtype))
                m.copy_(m32)
                v.copy_(v32)
        else:
            if self.sides is not None:
                grads = [g if not st else shard_of(p, precondition_(
                    gather_leaf_value(p, g), st, refresh, self.inner.opts))
                         for p, g, st in zip(self.params, grads, self.sides)]
            if self.trace is not None:
                # optax's trace: t = g + momentum * t
                torch._foreach_mul_(self.trace, self.momentum)
                torch._foreach_add_(self.trace, grads)
                grads = self.trace
            ups = list(grads)
        return torch._foreach_mul(ups, neg_lr)

    @torch.no_grad()
    def apply(self, kind: str, scale: float = 1.0) -> None:
        """One call of `kind` on the parameters' .grad, on the device only;
        the parameters move by `scale` times the chain's update."""
        grads = [p.grad for p in self.params]
        if self.every > 1:
            # optax.MultiSteps: acc += (g - acc) / (mini_step + 1)
            delta = torch._foreach_sub(grads, self.acc)
            torch._foreach_div_(delta, (self.mini_t + 1).float())
            torch._foreach_add_(self.acc, delta)
            if kind == "accumulate":
                self.mini_t.add_(1)
                return
            self.mini_t.zero_()
            grads = self.acc
        if self.grad_clip > 0:
            clip_by_global_norm_(grads, self.grad_clip, self.params)
        ups = self._inner_update(grads, refresh=kind == "refresh")
        if self.max_change is not None:
            ups = self.max_change(ups, self.params)
        if scale != 1.0:
            torch._foreach_mul_(ups, scale)
        torch._foreach_add_(self.params, ups)
        if self.every > 1:
            torch._foreach_zero_(self.acc)

    # -- checkpoints ----------------------------------------------------------

    def _slots(self, i: int):
        """(tensor, the inner optimizer's key) of parameter i's state."""
        if self.kind == "adam":
            return [(self.moments[0][i], "exp_avg"), (self.moments[1][i], "exp_avg_sq")]
        if self.kind == "adam-lowmem":
            return [(self.moments[0][i], "mu"), (self.moments[1][i], "nu")]
        out = [] if self.trace is None else [(self.trace[i], "momentum_buffer")]
        return out + [(t, k) for k, t in (self.sides[i] if self.sides else {}).items()]

    def state_dict(self) -> dict:
        """The inner optimizer's state as it would hold it after `count`
        updates (references to the live tensors, as torch's optimizers
        give), the counters and `acc`."""
        for group in self.inner.param_groups:
            group["lr"] = self.schedule(max(self.count - 1, 0))
            if self.kind in ("adam-lowmem", "ngsgd"):
                group["count" if self.kind == "adam-lowmem" else "ng_count"] = self.count
        for i, p in enumerate(self.params):
            # before its first update an optimizer holds only what it made
            # at construction (NGSGD's covariances)
            st = {k: t for t, k in self._slots(i) if self.count > 0 or k.endswith(("_cov", "_inv"))}
            if self.kind == "adam" and self.count > 0:
                st["step"] = torch.tensor(float(self.count))
            if st:
                self.inner.state[p] = st
        try:
            inner = self.inner.state_dict()
        finally:
            self.inner.state.clear()
        return dict(inner=inner, count=self.count, mini_step=self.mini_step,
                    acc=self.acc if self.every > 1 else None)

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        """Restore a `state_dict` by copying into this chain's tensors (a
        state the checkpoint lacks starts afresh: zeros, or NGSGD's
        identities)."""
        self.inner.load_state_dict(state["inner"])
        try:
            for i, p in enumerate(self.params):
                saved = self.inner.state.get(p, {})
                for t, k in self._slots(i):
                    if k in saved:
                        t.copy_(saved[k])
                    elif k.endswith(("_cov", "_inv")):
                        t.copy_(torch.eye(t.shape[0], dtype=t.dtype, device=t.device))
                    else:
                        t.zero_()
        finally:
            self.inner.state.clear()
        self.count, self.mini_step = int(state["count"]), int(state["mini_step"])
        self.count_t.fill_(self.count)
        self.mini_t.fill_(self.mini_step)
        if self.every > 1:
            for a, s in zip(self.acc, state["acc"] or [None] * len(self.acc)):
                a.zero_() if s is None else a.copy_(s)


def make_optimizer(cfg, params) -> ChainOptimizer:
    return ChainOptimizer(params, cfg)
