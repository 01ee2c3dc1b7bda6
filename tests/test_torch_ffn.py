"""ops/fused_ffn.py of the PyTorch port against the JAX package's
torchain_tpu.ops.fused_ffn: the plain versions of kernels K10f / K10b
against the Pallas kernels in interpret mode (`_ffn_fused(..., 0.5, True)`,
d=128, f=256, as tests/test_fused_ffn.py runs them), and `ffn_apply`
against the JAX `ffn_apply` at a shape the TPU kernel does not take (d=96,
f=192).  Inputs are made with numpy from a seed and handed to both sides.

Tolerance: forward rtol/atol 2e-5 in float32 (256-term float32 sums in
another order); the six gradients rtol/atol 2e-4 (sums over up to 1040
rows); bfloat16 forward rtol/atol 2e-2 (one rounding step of the output,
and of a hidden activation that sits on a rounding boundary).  The
bfloat16 gradients are held to 2e-2 of each gradient's largest entry."""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax
import jax.numpy as jnp
import torch

from torchain_tpu.ops import fused_ffn as jf
from torchain_tpu_torch.ops import fused_ffn as tf

NAMES = ["xn", "res", "w1", "b1", "w2", "b2"]


def _setup(n, d, f, seed):
    rng = np.random.default_rng(seed)
    r = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    args = [r(n, d), r(n, d), r(d, f) * 0.3, r(f) * 0.1, r(f, d) * 0.3, r(d) * 0.1]
    return args, r(n, d)


def _jax_fused(args, g, jdt=jnp.float32):
    """Output and the six gradients of the interpret-mode Pallas pair."""
    jargs = [jnp.asarray(a) for a in args]
    jargs[0], jargs[1] = jargs[0].astype(jdt), jargs[1].astype(jdt)

    def loss(*a):
        out = jf._ffn_fused(*a, 0.5, True)
        return jnp.sum(out.astype(jnp.float32) * g), out

    (_, out), grads = jax.value_and_grad(loss, argnums=tuple(range(6)), has_aux=True)(*jargs)
    return np.asarray(out, np.float32), [np.asarray(x, np.float32) for x in grads]


@pytest.mark.parametrize("n", [48, 1040])
def test_plain_twins_match_jax_kernels_float32(n):
    args, g = _setup(n, 128, 256, seed=0)
    j_out, j_grads = _jax_fused(args, g)
    xn, res, w1, b1, w2, b2 = (torch.tensor(a) for a in args)
    out = tf.ffn_forward_plain(xn, res, w1, b1, w2, b2, 0.5)
    np.testing.assert_allclose(out.numpy(), j_out, rtol=2e-5, atol=2e-5)
    dx, dw1, db1, dw2, db2 = tf.ffn_backward_plain(xn, torch.tensor(g), w1, b1, w2, 0.5)
    for got, want, name in zip((dx, torch.tensor(g), dw1, db1, dw2, db2), j_grads, NAMES):
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4, err_msg=f"grad {name}")
    # on a CPU tensor the wrappers take the plain versions, without a launch
    assert torch.equal(tf.ffn_forward(xn, res, w1, b1, w2, b2, 0.5), out)
    assert torch.equal(tf.ffn_backward(xn, torch.tensor(g), w1, b1, w2, 0.5)[1], dw1)
    assert tf.ffn_forward.launches == 0 and tf.ffn_backward.launches == 0


def test_plain_twins_match_jax_kernels_bfloat16():
    args, g = _setup(64, 128, 256, seed=1)
    j_out, j_grads = _jax_fused(args, g, jnp.bfloat16)
    xn, res, w1, b1, w2, b2 = (torch.tensor(a) for a in args)
    xn, res = xn.to(torch.bfloat16), res.to(torch.bfloat16)
    out = tf.ffn_forward_plain(xn, res, w1, b1, w2, b2, 0.5)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), j_out, rtol=2e-2, atol=2e-2)
    # the backward keeps the Pallas body's roundings: g, h and dhb rounded to
    # bfloat16, db1 from the unrounded dh
    tg = torch.tensor(g).to(torch.bfloat16)
    dx, dw1, db1, dw2, db2 = tf.ffn_backward_plain(xn, tg, w1, b1, w2, 0.5)
    assert dx.dtype == torch.bfloat16 and dw1.dtype == db1.dtype == torch.float32
    for got, want, name in zip((dx, tg, dw1, db1, dw2, db2), j_grads, NAMES):
        np.testing.assert_allclose(got.float().numpy(), want, atol=2e-2 * np.abs(want).max(),
                                   err_msg=f"grad {name}")


@pytest.mark.parametrize("lead", [(32,), (2, 16)])
def test_ffn_apply_matches_jax_at_a_non_aligned_shape(lead):
    n = int(np.prod(lead))
    args, g = _setup(n, 96, 192, seed=2)
    jargs = [jnp.asarray(a) for a in args]
    jargs[0], jargs[1] = jargs[0].reshape(*lead, 96), jargs[1].reshape(*lead, 96)
    jg = jnp.asarray(g).reshape(*lead, 96)

    def loss(*a):
        out = jf.ffn_apply(*a, 0.5)
        return jnp.sum(out * jg), out

    (_, j_out), j_grads = jax.value_and_grad(loss, argnums=tuple(range(6)), has_aux=True)(*jargs)
    targs = [torch.tensor(np.asarray(a)).requires_grad_() for a in jargs]
    out = tf.ffn_apply(*targs, 0.5)
    assert out.shape == (*lead, 96)
    torch.sum(out * torch.tensor(np.asarray(jg))).backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out), rtol=2e-5, atol=2e-5)
    for t, want, name in zip(targs, j_grads, NAMES):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4,
                                   err_msg=f"grad {name}")


def test_plain_backward_is_the_gradient_of_the_forward_float32():
    """In float32 nothing is rounded, so the written-out backward equals
    autograd of the plain forward."""
    args, g = _setup(40, 24, 56, seed=3)
    targs = [torch.tensor(a, dtype=torch.float64).requires_grad_() for a in args]
    xn, res, w1, b1, w2, b2 = targs
    u = xn @ w1 + b1
    out = res + 0.5 * ((u * torch.sigmoid(u)) @ w2 + b2)
    torch.sum(out * torch.tensor(g, dtype=torch.float64)).backward()
    got = tf.ffn_backward_plain(*(torch.tensor(a) for a in (args[0], g, args[2], args[3], args[4])), 0.5)
    for t, want in zip(got, (xn, w1, b1, w2, b2)):
        np.testing.assert_allclose(t.numpy(), want.grad.numpy(), rtol=2e-4, atol=2e-5)


def _tf32(x):
    """x with the low 13 of its 23 mantissa bits cleared: the TF32 value the
    tensor cores read from a float32 register."""
    return (x.view(torch.int32) & ~0x1FFF).view(torch.float32)


def _three_tf32(a, b):
    """a @ b as csrc/fused_ffn.cu multiplies float32 operands on the tensor
    cores: each operand split as hi = tf32(x), lo = tf32(x - hi), and
    lo.hi + hi.lo + hi.hi summed in float32 (lo.lo dropped)."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return (al @ bh + ah @ bl) + ah @ bh


def test_three_tf32_products_stay_within_the_card_tolerance():
    """Sizes the float32 tolerance of the card checks (chip_smoke.py and
    tests/test_torch_cuda.py: 1e-4 absolute and relative) for the kernels'
    3xTF32 products: at the conformer's widths (D=256, F=1024; 1024 rows,
    weights of their initialiser's scale, as chip_smoke.py draws them) the
    forward and the weight gradients computed with the split products sit
    within it of a float64 reference, and so does the plain float32 version
    (its own error is of the same order)."""
    rng = np.random.default_rng(4)
    n, d, f = 1024, 256, 1024
    r = lambda *s: rng.standard_normal(s)  # noqa: E731
    xn, res, g = r(n, d), r(n, d), r(n, d)
    w1, w2 = r(d, f) * d ** -0.5, r(f, d) * f ** -0.5
    b1, b2 = r(f) * 0.1, r(d) * 0.1

    def run(mm, dt):
        t = [torch.tensor(a, dtype=dt) for a in (xn, res, g, w1, b1, w2, b2)]
        x, rs, gg, a1, c1, a2, c2 = t
        u = mm(x, a1) + c1
        sig = torch.sigmoid(u)
        h = u * sig
        out = rs + 0.5 * (mm(h, a2) + c2)
        dh = mm(gg, a2.t()) * 0.5 * (sig * (1.0 + u * (1.0 - sig)))
        dw1 = mm(x.t().contiguous(), dh)
        dw2 = 0.5 * mm(h.t().contiguous(), gg)
        return [v.double() for v in (out, dw1, dw2)]

    want = run(torch.matmul, torch.float64)
    for mm in (_three_tf32, torch.matmul):
        for got, ref, name in zip(run(mm, torch.float32), want, ("out", "dw1", "dw2")):
            torch.testing.assert_close(got, ref, atol=1e-4, rtol=1e-4, msg=lambda m, name=name: f"{name}: {m}")
    # the split matters: a single TF32 product would miss the tolerance
    single = lambda a, b: _tf32(a) @ _tf32(b)  # noqa: E731
    got = run(single, torch.float32)[1]
    assert not torch.allclose(got, want[1], atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
def test_ffn_apply_at_dim_512_takes_the_kernels_and_matches_jax(monkeypatch, dtype):
    """At D 512 (a conformer of dim 512: rows the kernels cut into two
    column groups) `ffn_apply` goes through the kernels' autograd.Function
    (on the CPU, their plain versions), and its output and six gradients
    match the JAX package's Pallas pair in interpret mode, within the
    tolerances of the float32 and bfloat16 cases above."""
    n, d, f = 24, 512, 256
    args, g = _setup(n, d, f, seed=3)
    j_out, j_grads = _jax_fused(args, g, jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    ts = [torch.tensor(a).requires_grad_() for a in args]
    ts[0] = torch.tensor(args[0]).to(dtype).requires_grad_()
    ts[1] = torch.tensor(args[1]).to(dtype).requires_grad_()
    calls = []
    real = tf._FfnApply.apply
    monkeypatch.setattr(tf._FfnApply, "apply", lambda *a: calls.append(tuple(a[0].shape)) or real(*a))
    out = tf.ffn_apply(*ts, 0.5)
    torch.sum(out.float() * torch.tensor(g)).backward()
    assert calls == [(n, d)] and out.dtype == dtype
    if dtype == torch.float32:
        np.testing.assert_allclose(out.detach().numpy(), j_out, rtol=2e-5, atol=2e-5)
        for t, want, name in zip(ts, j_grads, NAMES):
            np.testing.assert_allclose(t.grad.numpy(), want, rtol=2e-4, atol=2e-4,
                                       err_msg=f"grad {name}")
    else:
        np.testing.assert_allclose(out.detach().float().numpy(), j_out, rtol=2e-2, atol=2e-2)
        for t, want, name in zip(ts, j_grads, NAMES):
            np.testing.assert_allclose(t.grad.float().numpy(), want,
                                       atol=2e-2 * np.abs(want).max(), err_msg=f"grad {name}")
