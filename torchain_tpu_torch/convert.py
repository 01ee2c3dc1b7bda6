"""Carry parameters from the JAX package's flax models into this port.

`params_from_jax(params, batch_stats, cfg)` flattens the flax `params` and
`batch_stats` trees (nested dicts of numpy-convertible arrays, e.g.
`tdnnf0/linear_pre/kernel [2, in, out]`, `input_proj/kernel [1, F, H]`,
`block0/attn_qkv/kernel [D, 3D]`, `chain_head/BatchNorm_0/scale`) onto the
port's `state_dict` keys (`tdnnf0.linear_pre.kernel`, ...).  The model
family follows the config: a `TdnnfConfig` gives a `TDNNF`, a `TdnnConfig`
a `TDNN`, a `ConformerConfig` a `Conformer`.  The port keeps flax's names
and shapes, so the mapping is a renaming; every key and shape is checked
against a model built from `cfg`.
"""

from __future__ import annotations

import numpy as np
import torch

from torchain_tpu_torch.models.conformer import Conformer, ConformerConfig
from torchain_tpu_torch.models.tdnn import TDNN, TDNNF, TdnnConfig, TdnnfConfig

#: per config type: the model class and the input layer whose kernel
#: [K, feat_dim, out] tells the feature dimension
_FAMILIES = {
    TdnnfConfig: (TDNNF, "input_proj.kernel"),
    TdnnConfig: (TDNN, "tdnn0.kernel"),
    ConformerConfig: (Conformer, "frontend.kernel"),
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


def params_from_jax(
    params, batch_stats, cfg: TdnnfConfig | TdnnConfig | ConformerConfig
) -> dict[str, torch.Tensor]:
    """A state_dict for `TDNNF(cfg, feat_dim)`, `TDNN(cfg, feat_dim)` or
    `Conformer(cfg, feat_dim)`, by the type of `cfg`, holding the flax
    values.  Raises on a missing, extra or mis-shaped entry."""
    if type(cfg) not in _FAMILIES:
        raise TypeError(
            f"expected a TdnnfConfig, a TdnnConfig or a ConformerConfig, got {type(cfg).__name__}")
    model_cls, input_kernel = _FAMILIES[type(cfg)]
    flat = {**_flatten(params), **_flatten(batch_stats)}
    if input_kernel not in flat:
        raise ValueError(f"flax tree mismatch: missing ['{input_kernel}']")
    feat_dim = np.shape(flat[input_kernel])[1]
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
