"""Carry parameters from the JAX package's flax models into this port.

`params_from_jax(params, batch_stats, cfg)` flattens the flax `params` and
`batch_stats` trees (nested dicts of numpy-convertible arrays, e.g.
`tdnnf0/linear_pre/kernel [2, in, out]`, `input_proj/kernel [1, F, H]`,
`block0/attn_qkv/kernel [D, 3D]`, `lstm3/w_x [C, 4*cell]`, `conv0/kernel
[3, 3, 1, 48]`, `chain_head/BatchNorm_0/scale`) onto the port's
`state_dict` keys (`tdnnf0.linear_pre.kernel`, ...).  The model family
follows the config: a `TdnnfConfig` gives a `TDNNF`, a `TdnnConfig` a
`TDNN`, a `ConformerConfig` a `Conformer`, a `TdnnLstmConfig` a
`TDNNLSTM`, a `CnnTdnnConfig` a `CNNTDNN`.  The port keeps flax's names and
shapes under every lowering (nn.Conv's `kernel`/`bias`, as the "conv"
TDNN-F's `affine/bias`; the stock BatchNorm's `scale`/`bias` and running
`mean`/`var`; the stock LayerNorm's `scale`/`bias`), so the mapping is a
renaming; every key and shape is checked against a model built from `cfg`.
"""

from __future__ import annotations

import numpy as np
import torch

from torchain_tpu_torch.models.cnn import CNNTDNN, CnnTdnnConfig
from torchain_tpu_torch.models.conformer import Conformer, ConformerConfig
from torchain_tpu_torch.models.lstm import TDNNLSTM, TdnnLstmConfig
from torchain_tpu_torch.models.tdnn import TDNN, TDNNF, TdnnConfig, TdnnfConfig


def _lstm_input(cfg: TdnnLstmConfig) -> tuple[str, int]:
    kind = cfg.layers[0][0]
    return ("tdnn0.kernel", 1) if kind == "tdnn" else (f"{kind}0.w_x", 0)


#: per config type: the model class and (the input layer's parameter, the
#: axis of its shape that is the feature dimension); the CNN's feature
#: dimension is its config's
_FAMILIES = {
    TdnnfConfig: (TDNNF, lambda cfg: ("input_proj.kernel", 1)),
    TdnnConfig: (TDNN, lambda cfg: ("tdnn0.kernel", 1)),
    ConformerConfig: (Conformer, lambda cfg: ("frontend.kernel", 1)),
    TdnnLstmConfig: (TDNNLSTM, _lstm_input),
    CnnTdnnConfig: (CNNTDNN, lambda cfg: None),
}


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(_flatten(v, key))
        else:
            out[key] = v
    return out


def params_from_jax(params, batch_stats, cfg) -> dict[str, torch.Tensor]:
    """A state_dict for the model of `cfg`'s family (`TDNNF(cfg, feat_dim)`,
    ...), holding the flax values.  Raises on a missing, extra or
    mis-shaped entry."""
    if type(cfg) not in _FAMILIES:
        raise TypeError(
            "expected a TdnnfConfig, a TdnnConfig, a ConformerConfig, a TdnnLstmConfig or a"
            f" CnnTdnnConfig, got {type(cfg).__name__}")
    model_cls, input_of = _FAMILIES[type(cfg)]
    flat = {**_flatten(params), **_flatten(batch_stats)}
    where = input_of(cfg)
    if where is None:
        feat_dim = cfg.feat_dim
    else:
        if where[0] not in flat:
            raise ValueError(f"flax tree mismatch: missing ['{where[0]}']")
        feat_dim = np.shape(flat[where[0]])[where[1]]
    ref = model_cls(cfg, feat_dim, device="meta").state_dict()
    missing = sorted(set(ref) - set(flat))
    extra = sorted(set(flat) - set(ref))
    if missing or extra:
        raise ValueError(f"flax tree mismatch: missing {missing}, extra {extra}")
    out = {}
    for k, v in flat.items():
        t = torch.tensor(np.asarray(v, dtype=np.float32))
        if tuple(t.shape) != tuple(ref[k].shape):
            raise ValueError(f"{k}: shape {tuple(t.shape)} != {tuple(ref[k].shape)}")
        out[k] = t
    return out
