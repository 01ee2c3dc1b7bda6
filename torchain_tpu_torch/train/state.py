"""Train state: the model, its optimizer and the step count."""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class ChainTrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


def create_train_state(model: torch.nn.Module, lr: float = 1e-3,
                       capturable: bool = False) -> ChainTrainState:
    """Adam with optax's defaults (b1 0.9, b2 0.999, eps 1e-8).
    `capturable=True` keeps Adam's step count and bias correction on the
    card, as a captured train step needs (`make_train_step(capture=True)`);
    it computes 1 - beta**t in float32, as optax does, where the default
    computes it in float64 (each update about 7e-6 apart).  torch takes it
    for a model on the card only, so a CPU model raises ValueError."""
    if capturable and next(model.parameters()).device.type != "cuda":
        raise ValueError("capturable=True: Adam keeps its step on the card, and the model is"
                         f" on {next(model.parameters()).device}")
    opt = torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8,
                           capturable=capturable)
    return ChainTrainState(model=model, optimizer=opt)
