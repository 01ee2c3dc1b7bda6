"""models — the TDNN-F, TDNN and conformer encoders with chain + xent heads,
and the semi-orthogonal constraint of TDNN-F's factored layers."""

from torchain_tpu_torch.models.conformer import Conformer, ConformerConfig
from torchain_tpu_torch.models.semi_orthogonal import (
    constrain_semi_orthogonal,
    orthogonality_error,
    semi_orthogonal_step,
)
from torchain_tpu_torch.models.tdnn import (
    TDNN,
    TDNNF,
    ChainBatchNorm,
    TdnnConfig,
    TdnnfConfig,
    continuous_dropout,
)

__all__ = [
    "TDNN",
    "TDNNF",
    "ChainBatchNorm",
    "Conformer",
    "ConformerConfig",
    "TdnnConfig",
    "TdnnfConfig",
    "constrain_semi_orthogonal",
    "continuous_dropout",
    "orthogonality_error",
    "semi_orthogonal_step",
]
