"""The yardstick's counts pinned at the cells' shapes, the model FLOPs
held against torch's own count of the reference's products, and the
bound's choice of operations or bytes."""

from __future__ import annotations

import importlib
import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from chainbench.reference.ops import Products
from chainbench.rooflines import (
    PEAK_BF16_FLOPS,
    PEAK_BYTES,
    attention_counts,
    bound_s,
    den_counts,
    model_flops,
    num_counts,
)
from chainbench.spec import HERE


def _cfg(name):
    return json.loads((HERE / "configs" / f"{name}.json").read_text())["reference"]


@pytest.mark.parametrize("config,B,T,fsf,T_in,F,flops", [
    ("tdnnf_librispeech", 128, 50, 3, 232, 220, 453355765760.0),
    ("conformer_m", 64, 150, 4, 604, 80, 560480256000.0),
    ("conformer_m", 128, 50, 4, 204, 80, 363167744000.0),
])
def test_model_flops_at_the_cells(config, B, T, fsf, T_in, F, flops):
    """F: the model's input, 40 MFCC spliced -1,0,1 and a 100-dim i-vector
    (TDNN-F), 80 filterbanks (conformer); 7,055 pdfs."""
    cfg = _cfg(config)
    mod = importlib.import_module(f"chainbench.reference.{cfg['module']}")
    left, right = mod.context(cfg)
    assert fsf * T + left + right == T_in
    assert model_flops(cfg["module"], cfg, B, T_in, F, 7055) == flops


@pytest.mark.parametrize("kind", ["tdnnf", "conformer"])
def test_model_flops_count_the_references_products(tiny, kind):
    """torch's flop counter over the reference's forward at a small size
    counts the same products (the depthwise taps are no product)."""
    cell = tiny(kind)
    cfg = cell.config["reference"]
    mod = importlib.import_module(f"chainbench.reference.{cfg['module']}")
    left, right = mod.context(cfg)
    B, T, F, P = 3, 10, 12, 48
    T_in = 4 * T + left + right
    from chainbench.program import make_model

    model = make_model(cell.config, P, F, device="cpu")
    params = {n: p.detach() for n, p in model.named_parameters()}
    with FlopCounterMode(display=False) as counter:
        mod.forward(params, torch.randn(B, T_in, F), cfg, Products())
    assert counter.get_total_flops() == model_flops(cfg["module"], cfg, B, T_in, F, P)


def test_kernel_counts_at_the_cells():
    assert attention_counts(64, 150, 256, 4) == (4423680000.0, 55147200.0)
    assert attention_counts(128, 50, 256, 4) == (983040000.0, 36164800.0)
    assert den_counts(128, 50, 7055, 4163, 29926, 15826) == (1171251200.0, 361472572.0)
    assert num_counts(35000, 9000, 100000) == (656000.0, 1760000.0)


def test_the_bound_is_the_larger_of_operations_and_bytes():
    assert bound_s(989e12, 1.0, PEAK_BF16_FLOPS) == pytest.approx(1.0)
    assert bound_s(1.0, 3.35e12, PEAK_BF16_FLOPS) == pytest.approx(1.0)
    assert bound_s(989e12, 2 * PEAK_BYTES, PEAK_BF16_FLOPS) == pytest.approx(2.0)
