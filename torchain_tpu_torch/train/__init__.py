"""train — the chain training step, its optimizer and the Trainer."""

from torchain_tpu_torch.train.lowmem_adam import LowmemAdam
from torchain_tpu_torch.train.ngsgd import NGSGD, NGOptions
from torchain_tpu_torch.train.state import ChainTrainState, create_train_state
from torchain_tpu_torch.train.step import (
    clip_by_global_norm_,
    make_backstitch_step,
    make_eval_step,
    make_forward_fn,
    make_train_step,
)
from torchain_tpu_torch.train.trainer import (
    ChainOptimizer,
    Trainer,
    TrainerConfig,
    make_optimizer,
    max_change,
    parse_dropout_schedule,
)

__all__ = [
    "ChainOptimizer",
    "ChainTrainState",
    "LowmemAdam",
    "NGOptions",
    "NGSGD",
    "Trainer",
    "TrainerConfig",
    "clip_by_global_norm_",
    "create_train_state",
    "make_backstitch_step",
    "make_eval_step",
    "make_forward_fn",
    "make_optimizer",
    "make_train_step",
    "max_change",
    "parse_dropout_schedule",
]
