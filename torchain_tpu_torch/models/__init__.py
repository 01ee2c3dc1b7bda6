"""models — the TDNN-F, TDNN, TDNN-LSTM, CNN-TDNN and conformer encoders with
chain + xent heads, and the semi-orthogonal constraint of the factored
layers."""

from torchain_tpu_torch.models.cnn import CNNTDNN, CnnTdnnConfig
from torchain_tpu_torch.models.conformer import Conformer, ConformerConfig
from torchain_tpu_torch.models.lstm import TDNNLSTM, Lstmp, Opgru, TdnnLstmConfig
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
    "CNNTDNN",
    "TDNN",
    "TDNNF",
    "TDNNLSTM",
    "ChainBatchNorm",
    "CnnTdnnConfig",
    "Conformer",
    "ConformerConfig",
    "Lstmp",
    "Opgru",
    "TdnnConfig",
    "TdnnLstmConfig",
    "TdnnfConfig",
    "constrain_semi_orthogonal",
    "continuous_dropout",
    "orthogonality_error",
    "semi_orthogonal_step",
]
