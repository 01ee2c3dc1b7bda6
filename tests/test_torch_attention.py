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
#: lengths past one 64-row tile of the kernels, and past the first design's
#: limits (its backward took T <= 117 at dh 64)
LONG = [(1, 118, 2, 8), (1, 150, 2, 8)]
#: head widths past 64, which the kernels pad to tiles 96 and 128 wide (one
#: of each width exact, one below it), the second shape past one T tile
WIDE = [(2, 19, 2, 96), (1, 70, 1, 128), (2, 13, 1, 80), (1, 21, 1, 100)]


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


@pytest.mark.parametrize("B,T,H,dh", CASES + LONG)
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
@pytest.mark.parametrize("B,T,H,dh", CASES[:2] + LONG + WIDE)
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


def _stub_library(monkeypatch, need):
    """A stub library that asks for `need` bytes of shared memory per block
    and records what it was asked; with tensors on the meta device, which
    pass the CPU test and reach the check without data."""
    asked = []

    class Lib:
        def attention_shared_bytes(self, dh, bf16, bwd):
            asked.append((dh, bf16, bwd))
            return need

        def attention_shared_limit(self):
            return 232_448

    monkeypatch.setattr(kernels, "entry", lambda name, fn: getattr(Lib(), fn))
    monkeypatch.setattr(kernels, "check_tensor", lambda *a, **k: None)
    monkeypatch.setattr(ta, "_FITS", set())
    return asked


def _meta(B, T, H, dh):
    return (torch.empty(B, T, 3 * H * dh, device="meta"), torch.empty(H, T, T, device="meta"),
            torch.empty(B, T, H * dh, device="meta"))


@pytest.mark.parametrize("backward", [0, 1], ids=["forward", "backward"])
def test_each_direction_checks_its_own_shared_memory(monkeypatch, backward):
    """The forward's block holds five tiles of 64 rows by the padded head
    width, the backward's larger launch eight: whatever T, each wrapper asks
    the library for its own direction's need at its head width and dtype,
    and raises where the card cannot give it."""
    asked = _stub_library(monkeypatch, 1 << 30)
    B, T, H, dh = 2, 512, 4, 64
    qkv, bias, g = _meta(B, T, H, dh)
    with pytest.raises(ValueError, match="shared memory"):
        if backward:
            ta.attention_backward(qkv, bias, g, H, 0.125)
        else:
            ta.attention_forward(qkv, bias, H, 0.125)
    assert asked == [(dh, 0, backward)]


@pytest.mark.parametrize("backward", [0, 1], ids=["forward", "backward"])
def test_wrappers_refuse_a_head_wider_than_the_kernels_take(monkeypatch, backward):
    """The library answers -1 for a head width it does not take (above 128):
    the wrappers raise, they do not fall back."""
    asked = _stub_library(monkeypatch, -1)
    qkv, bias, g = _meta(1, 40, 1, 136)
    with pytest.raises(ValueError, match="head width"):
        if backward:
            ta.attention_backward(qkv, bias, g, 1, 0.125)
        else:
            ta.attention_forward(qkv, bias, 1, 0.125)
    assert asked == [(136, 0, backward)]


def _tf32(x):
    """x with the low 13 of its 23 mantissa bits cleared: the TF32 value the
    tensor cores read from a float32 register."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _three_tf32(a, b):
    """a @ b as csrc/attention.cu multiplies float32 operands: each split as
    hi = tf32(x), lo = tf32(x - hi), lo.hi + hi.lo + hi.hi (lo.lo dropped)."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return (al @ bh + ah @ bl) + ah @ bh


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _hi_lo(a, b):
    """a @ b for a float32 a against bfloat16 values b, a split in two: hi =
    bf16(a), lo = bf16(a - hi), two exact bfloat16 products summed in
    float32 (the split the kernels do not take: too coarse)."""
    hi = _bf16(a)
    return _bf16(a - hi) @ b + hi @ b


def _hi_mid_lo(a, b):
    """a @ b for a float32 a (p or dl) against bfloat16 values b, as the
    kernels take it: a split as hi = bf16(a), mid = bf16(a - hi), lo =
    bf16(a - hi - mid), three exact bfloat16 products summed in float32,
    the smallest first."""
    hi = _bf16(a)
    mid = _bf16(a - hi)
    return (_bf16(a - hi - mid) @ b + mid @ b) + hi @ b


def _online(s, fn, tile=64):
    """Row statistics over key tiles as the kernels keep them: the running
    maximum m, sum of exp(s - m) and, where `fn` is given, the running sum
    fn(exp(s - m), tile start) that the maximum rescales."""
    m = torch.full(s.shape[:-1], -torch.inf)
    l = torch.zeros(s.shape[:-1])
    acc = None
    for c0 in range(0, s.shape[-1], tile):
        st = s[..., c0:c0 + tile]
        mn = torch.maximum(m, st.amax(-1))
        corr, e = torch.exp(m - mn), torch.exp(st - mn[..., None])
        l = l * corr + e.sum(-1)
        x = fn(e, c0)
        acc = x if acc is None else acc * corr.reshape(corr.shape + (1,) * (x.dim() - corr.dim())) + x
        m = mn
    return m, l, acc


def _kernel_arithmetic(qkv, bias, g, H, scale, product):
    """K7f and K7b as csrc/attention.cu computes them, in float32 on the CPU:
    q k^T and g v^T as products of the operands read from the tiles (exact
    bfloat16 products; 3xTF32 for float32), the online softmax over key
    tiles of 64, out = (sum_s e v) / l, the statistics lse and delta, and
    every product with a float32 p or dl through `product`."""
    B, T, D3 = qkv.shape
    D, dh = D3 // 3, D3 // 3 // H
    bf16 = qkv.dtype == torch.bfloat16
    mm = (lambda a, b: a @ b) if bf16 else _three_tf32  # noqa: E731
    q, k, v = ta._heads(qkv.float(), H)
    go = g.float().reshape(B, T, H, dh).permute(0, 2, 1, 3)
    s = mm(q, k.transpose(-1, -2)) * scale + bias[None]
    dp = mm(go, v.transpose(-1, -2))
    _, l, o = _online(s, lambda e, c0: product(e, v[..., c0:c0 + 64, :]))
    out = ta._merge(o / l[..., None]).to(qkv.dtype)
    m, l, ds = _online(s, lambda e, c0: (e * dp[..., c0:c0 + 64]).sum(-1))
    lse, delta = m + torch.log(l), ds / l
    p = torch.exp(s - lse[..., None])
    dl = p * (dp - delta[..., None])
    dq = product(dl, k) * scale
    dk = product(dl.transpose(-1, -2), q) * scale
    dv = product(p.transpose(-1, -2), go)
    dqkv = torch.cat([ta._merge(dq), ta._merge(dk), ta._merge(dv)], dim=-1).to(qkv.dtype)
    return out, dqkv, dl.sum(0), ta._merge(o / l[..., None])


@pytest.mark.parametrize("T", [50, 150])
@pytest.mark.parametrize("bf16", [False, True], ids=["float32", "bfloat16"])
def test_split_products_stay_within_the_card_tolerance(T, bf16):
    """Sizes the kernels' split products against the card checks'
    tolerances (tests/test_torch_cuda.py: float32 2e-5 absolute and 1e-5
    relative, bfloat16 2e-2 and 1e-2; dbias 5e-5 and 1e-4) at the conformer's
    heads (4 of 64) and T = 50 and 150, over two and three key tiles'
    online softmax.  bfloat16: p and dl enter their products as hi + mid +
    lo, three bfloat16 values; the unrounded output misses the float64 sum
    by no more than the plain version's float32 sum does, and its bfloat16
    rounding departs from the plain version's in a fifth as many outputs as
    a split in two (hi + lo, whose error is several times larger) would
    give: with that split the card's bfloat16 outputs moved off the plain
    version's by one step far more often than float32 reordering makes
    them.  float32: every product in 3xTF32."""
    B, H, dh = 2, 4, 64
    qkv, bias, g = (torch.tensor(a) for a in _inputs(B, T, H, dh, seed=7))
    dtype = torch.bfloat16 if bf16 else torch.float32
    qkv, g = qkv.to(dtype), g.to(dtype)
    scale = 1.0 / np.sqrt(dh)
    product = _hi_mid_lo if bf16 else _three_tf32
    out, dqkv, dbias, raw = _kernel_arithmetic(qkv, bias, g, H, scale, product)
    want = ta.attention_forward_plain(qkv, bias, H, scale)
    dqkv_p, dbias_p = ta.attention_backward_plain(qkv, bias, g, H, scale)
    tol = dict(atol=2e-2, rtol=1e-2) if bf16 else dict(atol=2e-5, rtol=1e-5)
    torch.testing.assert_close(out, want, **tol)
    torch.testing.assert_close(dqkv, dqkv_p, **tol)
    torch.testing.assert_close(dbias, dbias_p, atol=5e-5, rtol=1e-4)
    if bf16:
        _, _, v, p = ta._probs(qkv, bias, H, scale)
        exact = ta._merge(p.double() @ v.double())
        plain_err = float((ta._merge(p @ v) - exact).abs().max())
        split_err = float((raw - exact).abs().max())
        two = ta._merge(_hi_lo(p, v))
        assert split_err <= 2 * plain_err
        assert float((two - exact).abs().max()) > 3 * split_err
        flips = int((out != want).sum())
        assert 5 * flips < int((two.to(dtype) != want).sum())


@pytest.mark.parametrize(
    "T, chunks, mbytes", [(50, 64, 2.7648), (150, 32, 12.1344), (512, 8, 35.651584)]
)
def test_backward_scratch_holds_the_statistics_and_the_chunk_partials(T, chunks, mbytes):
    """At the conformer's B=128, H=4: the batch is cut into as many chunks
    as keep the rows launch within one wave (396 blocks) and the partials
    within 32 MiB; the scratch holds lse and delta [B, H, T] and, with more
    than one chunk, a [H, T, T] partial of dbias per chunk.  One chunk
    (B=1) needs no partials: the rows launch sums into dbias itself."""
    B, H = 128, 4
    n = ta.backward_scratch_floats(B, T, H)
    assert n == 2 * B * H * T + chunks * H * T * T
    assert 4 * n / 1e6 == pytest.approx(mbytes)
    assert chunks * H * T * T <= 1 << 23
    assert ta.backward_scratch_floats(1, T, H) == 2 * H * T
