"""The semi-orthogonal constraint of the port (models/semi_orthogonal.py)
against the JAX package's (torchain_tpu/models/semi_orthogonal.py) on the
CPU, on the same numpy matrices: one step of `semi_orthogonal_step` on
wide, tall and far-from-orthonormal matrices (the latter take the quarter
speed), `orthogonality_error`, and `constrain_semi_orthogonal` over every
`linear_pre` kernel of a 3-layer TDNN-F carried by convert.params_from_jax,
applied 5 times.

Tolerance: float32 matrix products in another order; rtol 1e-5 with atol
1e-6 on the matrices (atol 1e-5 after 5 constraint steps) and rtol 1e-4 on
the error, which divides by a small norm near convergence."""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax
import jax.numpy as jnp
import torch

from torchain_tpu.models import TDNNF as JTDNNF
from torchain_tpu.models import TdnnfConfig as JCfg
from torchain_tpu.models.semi_orthogonal import constrain_semi_orthogonal as j_constrain
from torchain_tpu.models.semi_orthogonal import orthogonality_error as j_error
from torchain_tpu.models.semi_orthogonal import semi_orthogonal_step as j_step
from torchain_tpu_torch.convert import _flatten, params_from_jax
from torchain_tpu_torch.models import (
    TDNNF,
    TdnnfConfig,
    constrain_semi_orthogonal,
    orthogonality_error,
    semi_orthogonal_step,
)

SMALL = dict(num_pdfs=9, hidden_dim=32, bottleneck_dim=8, prefinal_dim=16, num_layers=3)


def _matrix(shape, seed, skew=False):
    rng = np.random.default_rng(seed)
    m = rng.normal(size=shape).astype(np.float32) / np.sqrt(shape[1])
    if skew:  # one dominant direction: far from orthonormal, quarter speed
        m[0] *= 30.0
    return m


@pytest.mark.parametrize(
    "shape,skew,nu",
    [((8, 64), False, 0.5), ((64, 8), False, 0.25), ((16, 48), True, 0.5), ((12, 12), False, 0.25)],
    ids=["wide", "tall", "skewed", "square"],
)
def test_step_and_error_match_jax(shape, skew, nu):
    m = _matrix(shape, seed=shape[0] + shape[1], skew=skew)
    want = np.asarray(j_step(jnp.asarray(m), nu))
    got = semi_orthogonal_step(torch.tensor(m), nu).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    for x in (m, want):
        np.testing.assert_allclose(float(orthogonality_error(torch.tensor(x))),
                                   float(j_error(jnp.asarray(x))), rtol=1e-4)
    # the step drives the matrix toward semi-orthogonality
    assert float(orthogonality_error(torch.tensor(got))) < float(
        orthogonality_error(torch.tensor(m)))


def test_constrain_over_a_tdnnf_matches_jax():
    jcfg, tcfg = JCfg(**SMALL), TdnnfConfig(**SMALL)
    left, right = tcfg.context
    feats = np.zeros((2, 6 * 3 + left + right, 8), np.float32)
    variables = JTDNNF(jcfg).init(jax.random.PRNGKey(5), jnp.asarray(feats), train=False)
    params, stats = variables["params"], variables["batch_stats"]
    model = TDNNF(tcfg, 8, device="cpu")
    model.load_state_dict(params_from_jax(params, stats, tcfg))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    for _ in range(5):
        params = j_constrain(params)
        assert constrain_semi_orthogonal(model) == SMALL["num_layers"]
    want = _flatten(jax.tree.map(np.asarray, params))
    for k, v in model.state_dict().items():
        if "linear_pre" in k:
            np.testing.assert_allclose(v.numpy(), want[k], rtol=1e-5, atol=1e-5, err_msg=k)
            assert not torch.equal(v, before[k])
            flat = v.reshape(-1, v.shape[-1])
            assert float(orthogonality_error(flat)) < float(
                orthogonality_error(before[k].reshape(-1, v.shape[-1])))
        else:  # nothing else moves
            assert torch.equal(v, before[k]), k
