"""The chain training step: model forward (two heads) -> chain loss (custom
gradient) -> gradients -> global-norm clip -> Adam.  Port of
torchain_tpu/train/step.py (make_train_step)."""

from __future__ import annotations

import torch

from torchain_tpu_torch.ops.chain_loss import ChainLossOptions, chain_loss
from torchain_tpu_torch.train.state import ChainTrainState


def clip_by_global_norm_(grads: list[torch.Tensor], max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm semantics: g * max_norm / ||g|| when
    ||g|| >= max_norm, else unchanged (torch's clip_grad_norm_ divides by
    ||g|| + 1e-6 instead).  Returns ||g|| before clipping."""
    norm = torch.sqrt(sum(torch.sum(torch.square(g)) for g in grads))
    factor = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    for g in grads:
        g.mul_(factor)
    return norm


def make_train_step(
    state: ChainTrainState,
    loss_opts: ChainLossOptions,
    use_xent: bool = True,
    max_grad_norm: float = 5.0,
):
    """Returns step(feats [B, T_in, F], den, sup) -> metrics, updating
    `state` in place (parameters, optimizer moments, batchnorm running
    statistics, step count).  Metric keys: loss, objf, l2_term, oor_term,
    xent_objf, weight, num_failed, grad_norm (0-d tensors)."""
    model, opt = state.model, state.optimizer
    params = [p for p in model.parameters() if p.requires_grad]

    def step(feats, den, sup) -> dict:
        model.train()
        chain_out, xent_out = model(feats, train=True)
        loss, aux = chain_loss(
            chain_out, xent_out if use_xent else None, den, sup, loss_opts
        )
        opt.zero_grad(set_to_none=False)
        loss.backward()
        grad_norm = clip_by_global_norm_([p.grad for p in params], max_grad_norm)
        opt.step()
        state.step += 1
        metrics = {k: v.detach() for k, v in aux.items()}
        metrics["loss"] = loss.detach()
        metrics["grad_norm"] = grad_norm
        return metrics

    return step
