"""Train state: the model, its optimizer and the step count."""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class ChainTrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


def create_train_state(model: torch.nn.Module, lr: float = 1e-3) -> ChainTrainState:
    """Adam with optax's defaults (b1 0.9, b2 0.999, eps 1e-8)."""
    opt = torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)
    return ChainTrainState(model=model, optimizer=opt)
