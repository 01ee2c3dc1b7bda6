"""ops/fused_ln.py of the PyTorch port against the JAX package's
torchain_tpu.ops.fused_ln.ln_apply: the output and the three gradients
(x, scale, bias) of a fixed weighted sum of the output, on the same inputs
made with numpy from a seed.

Tolerance, float32: atol 1e-5 on values of order 1 (row means and sums over
the batch in another order).  bfloat16 operand: the output and dx are
rounded to bfloat16 from float32 values that agree to 1e-5, so they may
differ by one bfloat16 step where that value sits on a rounding boundary:
atol 2e-2 on values of order 1 to 4; dscale and dbias are float32 sums of
the same bfloat16 inputs, rtol 1e-4 with atol 1e-4."""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax
import jax.numpy as jnp
import torch

from torchain_tpu.ops.fused_ln import ln_apply as j_ln_apply
from torchain_tpu_torch.ops.fused_ln import ln_apply

EPS = 1e-6


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    C = shape[-1]
    x = (rng.normal(size=shape) * 1.5 + 0.3).astype(np.float32)
    scale = (1.0 + 0.2 * rng.normal(size=C)).astype(np.float32)
    bias = (0.1 * rng.normal(size=C)).astype(np.float32)
    w = rng.normal(size=shape).astype(np.float32)
    return x, scale, bias, w


def _both(x, scale, bias, w, bf16):
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if bf16 else (jnp.float32, torch.float32)

    def jloss(x, s, b):
        y = j_ln_apply(x, s, b, EPS)
        return jnp.sum(y.astype(jnp.float32) * w), y

    (_, jy), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(x, jdt), jnp.asarray(scale), jnp.asarray(bias)
    )
    tx = torch.tensor(x).to(tdt).requires_grad_()
    ts, tb = torch.tensor(scale, requires_grad=True), torch.tensor(bias, requires_grad=True)
    ty = ln_apply(tx, ts, tb, EPS)
    torch.sum(ty.float() * torch.tensor(w)).backward()
    assert ty.dtype == tx.grad.dtype == tdt
    assert ts.grad.dtype == tb.grad.dtype == torch.float32
    got = [ty.detach().float().numpy()] + [t.grad.float().numpy() for t in (tx, ts, tb)]
    want = [np.asarray(jy, np.float32)] + [np.asarray(g, np.float32) for g in jg]
    return got, want


@pytest.mark.parametrize("shape", [(3, 7, 32), (5, 48), (2, 3, 4, 17)])
def test_ln_apply_matches_jax_float32(shape):
    got, want = _both(*_inputs(shape, 0), bf16=False)
    for g, w, name in zip(got, want, ("y", "dx", "dscale", "dbias")):
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-5, err_msg=name)


@pytest.mark.parametrize("shape", [(3, 7, 32), (4, 6, 64)])
def test_ln_apply_matches_jax_bfloat16(shape):
    got, want = _both(*_inputs(shape, 1), bf16=True)
    for g, w, name in zip(got[:2], want[:2], ("y", "dx")):
        np.testing.assert_allclose(g, w, atol=2e-2, err_msg=name)
        # all but a few elements agree exactly: the same float32 value was rounded
        assert np.mean(g == w) > 0.98, name
    for g, w, name in zip(got[2:], want[2:], ("dscale", "dbias")):
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=1e-4, err_msg=name)


def test_ln_apply_constant_rows_have_zero_variance():
    """var = max(E[x^2] - mean^2, 0): a constant row normalises to the bias."""
    x = torch.full((2, 8), 3.0)
    y = ln_apply(x, torch.ones(8), torch.full((8,), 0.25), EPS)
    jy = j_ln_apply(jnp.full((2, 8), 3.0), jnp.ones(8), jnp.full((8,), 0.25), EPS)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-6)
    assert torch.isfinite(y).all()
