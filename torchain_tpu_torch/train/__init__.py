"""train — the chain training step over a model and torch.optim.Adam."""

from torchain_tpu_torch.train.state import ChainTrainState, create_train_state
from torchain_tpu_torch.train.step import clip_by_global_norm_, make_train_step

__all__ = [
    "ChainTrainState",
    "clip_by_global_norm_",
    "create_train_state",
    "make_train_step",
]
