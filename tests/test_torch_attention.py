"""ops/attention.py of the PyTorch port against the JAX package's
torchain_tpu.ops.attention: the plain versions of kernels K7f / K7b and
the autograd.Function around them against `fused_relpos_attention`, whose
Pallas kernels run in interpret mode on the CPU by themselves (as
tests/test_attention_kernel.py runs them), and `reference_relpos_attention`
against its namesake.  Inputs are made with numpy from a seed and handed to
both sides.

Tolerance: forward atol 1e-5 in float32 (dh- and T-term float32 sums in
another order, outputs of order 1) and 2e-2 with bfloat16 qkv (one
bfloat16 rounding step of an output of order 1 to 4); dqkv and dbias atol
2e-5 in float32 (dbias adds B slices in another order).  With bfloat16 qkv
the gradients are rounded to bfloat16: atol 2e-2 times the largest entry."""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax
import jax.numpy as jnp
import torch

from torchain_tpu.ops.attention import fused_relpos_attention as j_fused
from torchain_tpu.ops.attention import reference_relpos_attention as j_reference
from torchain_tpu_torch import kernels
from torchain_tpu_torch.ops import attention as ta

CASES = [  # B, T, H, dh
    (3, 17, 4, 16),
    (2, 23, 2, 32),
    (2, 12, 4, 8),
]


def _inputs(B, T, H, dh, seed=0):
    rng = np.random.default_rng(seed)
    qkv = rng.normal(size=(B, T, 3 * H * dh)).astype(np.float32)
    bias = (rng.normal(size=(H, T, T)) * 0.3).astype(np.float32)
    g = rng.normal(size=(B, T, H * dh)).astype(np.float32)
    return qkv, bias, g


def _jax_grads(fn, qkv, bias, g, H, scale, jdt):
    def loss(q, b):
        out = fn(q, b, H, scale)
        return jnp.sum(out.astype(jnp.float32) * g), out

    (_, out), (dq, db) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(qkv, jdt), jnp.asarray(bias)
    )
    return (np.asarray(a, np.float32) for a in (out, dq, db))


@pytest.mark.parametrize("B,T,H,dh", CASES)
def test_plain_twins_match_jax_kernels_float32(B, T, H, dh):
    qkv, bias, g = _inputs(B, T, H, dh)
    scale = float(1.0 / np.sqrt(dh))
    j_out, j_dqkv, j_dbias = _jax_grads(j_fused, qkv, bias, g, H, scale, jnp.float32)
    tq, tb, tg = torch.tensor(qkv), torch.tensor(bias), torch.tensor(g)
    out = ta.attention_forward_plain(tq, tb, H, scale)
    dqkv, dbias = ta.attention_backward_plain(tq, tb, tg, H, scale)
    np.testing.assert_allclose(out.numpy(), j_out, atol=1e-5)
    np.testing.assert_allclose(dqkv.numpy(), j_dqkv, atol=2e-5)
    np.testing.assert_allclose(dbias.numpy(), j_dbias, atol=2e-5)
    # on a CPU tensor the wrappers take the plain versions, without a launch
    assert torch.equal(ta.attention_forward(tq, tb, H, scale), out)
    assert torch.equal(ta.attention_backward(tq, tb, tg, H, scale)[0], dqkv)
    assert ta.attention_forward.launches == 0 and ta.attention_backward.launches == 0


@pytest.mark.parametrize("bf16", [False, True], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("B,T,H,dh", CASES[:2])
def test_autograd_function_matches_jax(B, T, H, dh, bf16):
    qkv, bias, g = _inputs(B, T, H, dh, seed=1)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if bf16 else (jnp.float32, torch.float32)
    scale = float(1.0 / np.sqrt(dh))
    j_out, j_dqkv, j_dbias = _jax_grads(j_fused, qkv, bias, g, H, scale, jdt)
    tq = torch.tensor(qkv).to(tdt).requires_grad_()
    tb = torch.tensor(bias, requires_grad=True)
    out = ta.fused_relpos_attention(tq, tb, H, scale)
    torch.sum(out.float() * torch.tensor(g)).backward()
    assert out.dtype == tq.grad.dtype == tdt and tb.grad.dtype == torch.float32
    got = [out.detach().float().numpy(), tq.grad.float().numpy(), tb.grad.numpy()]
    if bf16:
        np.testing.assert_allclose(got[0], j_out, atol=2e-2)
        np.testing.assert_allclose(got[1], j_dqkv, atol=2e-2 * np.abs(j_dqkv).max())
        # float32 sums over the batch of values computed from the same
        # bfloat16 inputs (g reaches both kernels rounded to bfloat16)
        np.testing.assert_allclose(got[2], j_dbias, atol=2e-5 + 1e-4 * np.abs(j_dbias).max())
    else:
        np.testing.assert_allclose(got[0], j_out, atol=1e-5)
        np.testing.assert_allclose(got[1], j_dqkv, atol=2e-5)
        np.testing.assert_allclose(got[2], j_dbias, atol=2e-5)


@pytest.mark.parametrize("bf16", [False, True], ids=["float32", "bfloat16"])
def test_reference_matches_jax_reference(bf16):
    B, T, H, dh = 3, 17, 4, 16
    qkv, bias, g = _inputs(B, T, H, dh, seed=2)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if bf16 else (jnp.float32, torch.float32)
    j_out, j_dqkv, j_dbias = _jax_grads(j_reference, qkv, bias, g, H, 0.25, jdt)
    tq = torch.tensor(qkv).to(tdt).requires_grad_()
    tb = torch.tensor(bias, requires_grad=True)
    out = ta.reference_relpos_attention(tq, tb, H, 0.25)
    torch.sum(out.float() * torch.tensor(g)).backward()
    assert out.dtype == tdt
    np.testing.assert_allclose(out.detach().float().numpy(), j_out, atol=2e-2 if bf16 else 1e-5)
    if not bf16:
        np.testing.assert_allclose(tq.grad.numpy(), j_dqkv, atol=2e-5)
        np.testing.assert_allclose(tb.grad.numpy(), j_dbias, atol=2e-5)
        # the kernel's arithmetic and the einsum form agree in float32
        plain = ta.attention_forward_plain(tq.detach(), tb.detach(), H, 0.25)
        np.testing.assert_allclose(plain.numpy(), j_out, atol=1e-5)


def test_bias_gradient_keeps_the_bias_dtype():
    """dbias is accumulated in float32 and cast to bias.dtype last."""
    qkv, bias, g = _inputs(2, 9, 2, 8, seed=3)
    tq = torch.tensor(qkv)
    tb = torch.tensor(bias).to(torch.bfloat16).requires_grad_()
    out = ta.fused_relpos_attention(tq, tb, 2, 0.3)
    torch.sum(out * torch.tensor(g)).backward()
    assert tb.grad.dtype == torch.bfloat16
    _, want = ta.attention_backward_plain(tq, tb.detach().float(), torch.tensor(g), 2, 0.3)
    assert torch.equal(tb.grad, want.to(torch.bfloat16))


@pytest.mark.parametrize("backward", [0, 1], ids=["forward", "backward"])
def test_each_direction_checks_its_own_shared_memory(monkeypatch, backward):
    """The forward kernel keeps three [T, dh] slices and the logits in
    shared memory, the backward four and two [T, T] arrays: at dh 64 the
    forward fits up to T=162 and the backward only up to T=117.  Each
    wrapper asks the library for its own direction's need (a stub library
    that refuses everything, and tensors on the meta device, which pass the
    CPU test and reach the check without data)."""
    asked = []

    class Lib:
        def attention_shared_bytes(self, T, dh, bwd):
            asked.append((T, dh, bwd))
            return 1 << 30

        def attention_shared_limit(self):
            return 232_448

    monkeypatch.setattr(kernels, "library", lambda name: Lib())
    monkeypatch.setattr(kernels, "check_tensor", lambda *a, **k: None)
    B, T, H, dh = 2, 150, 4, 64
    qkv = torch.empty(B, T, 3 * H * dh, device="meta")
    bias = torch.empty(H, T, T, device="meta")
    g = torch.empty(B, T, H * dh, device="meta")
    with pytest.raises(ValueError, match="shared memory"):
        if backward:
            ta.attention_backward(qkv, bias, g, H, 0.125)
        else:
            ta.attention_forward(qkv, bias, H, 0.125)
    assert asked == [(T, dh, backward)]
