"""TDNN-F of the PyTorch port (models/tdnn.py, ops/fused_bn.py) against the
JAX package's flax TDNNF, from the same parameters carried over by
convert.params_from_jax: outputs in train and eval mode, the gradient of a
fixed scalar of the outputs with respect to every parameter, and the
updated batchnorm running statistics.

Tolerance: atol 1e-5 on outputs and statistics, and on each gradient
rtol 1e-4 plus an atol of 1e-5 times that gradient's largest magnitude:
float32 matmuls and batch reductions in another order, through a few
layers of batchnorm (which divides by small per-channel spreads).

With the bfloat16 trunk (`TdnnfConfig.dtype`) the same tolerances hold for
the float32 outputs, the statistics and every gradient but three: the
biases that are added in bfloat16 (input_proj and each head's Dense_0) get
their gradient as a sum over all B*T rows rounded to bfloat16's 8 bits, and
the two frameworks round that sum at other places.  Those are held to 3e-2
of the gradient's largest magnitude (1.8e-2 seen over three seeds)."""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax
import jax.numpy as jnp
import torch

from torchain_tpu.models import TDNNF as JTDNNF
from torchain_tpu.models import TdnnfConfig as JCfg
from torchain_tpu_torch.convert import _flatten, params_from_jax
from torchain_tpu_torch.models import TDNNF, TdnnfConfig

SMALL = dict(num_pdfs=11, hidden_dim=64, bottleneck_dim=16, prefinal_dim=32, num_layers=3)


def _setup(jdtype=jnp.float32, tdtype=torch.float32):
    jcfg, tcfg = JCfg(dtype=jdtype, **SMALL), TdnnfConfig(dtype=tdtype, **SMALL)
    assert jcfg.context == tcfg.context
    assert jcfg.layer_geometry() == tcfg.layer_geometry()
    left, right = tcfg.context
    B, T_out, F = 3, 6, 8
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(B, T_out * 3 + left + right, F)).astype(np.float32)
    jm = JTDNNF(jcfg)
    variables = jm.init(jax.random.PRNGKey(3), jnp.asarray(feats), train=False)
    # non-trivial running statistics, so eval mode is exercised
    stats = jax.tree.map(
        lambda v: v + jnp.asarray(rng.random(size=v.shape).astype(np.float32)),
        variables["batch_stats"],
    )
    params = variables["params"]
    tm = TDNNF(tcfg, F, device="cpu")
    tm.load_state_dict(params_from_jax(params, stats, tcfg))
    w = rng.normal(size=(B, T_out, SMALL["num_pdfs"])).astype(np.float32)
    return jm, params, stats, tm, feats, w


@pytest.fixture(scope="module")
def setup():
    return _setup()


@pytest.fixture(scope="module")
def setup_bf16():
    return _setup(jnp.bfloat16, torch.bfloat16)


#: parameters whose gradient is a bfloat16 sum over rows under the bf16 trunk
BF16_SUMMED = ("input_proj.bias", "chain_head.Dense_0.bias", "xent_head.Dense_0.bias")


def test_eval_forward_matches(setup):
    jm, params, stats, tm, feats, _ = setup
    jc, jx = jm.apply({"params": params, "batch_stats": stats}, jnp.asarray(feats), train=False)
    with torch.no_grad():
        tc, tx = tm(torch.as_tensor(feats), train=False)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-5)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-5)


def test_train_forward_grads_and_stats_match(setup):
    _train_forward_grads_and_stats(setup, {})


def test_bf16_trunk_eval_forward_matches(setup_bf16):
    test_eval_forward_matches(setup_bf16)


def test_bf16_trunk_train_forward_grads_and_stats_match(setup_bf16):
    _train_forward_grads_and_stats(setup_bf16, dict.fromkeys(BF16_SUMMED, 3e-2))


def test_bf16_trunk_keeps_float32_parameters_outputs_and_gradients(setup_bf16):
    jm, params, stats, tm, feats, _ = setup_bf16
    assert tm.config.dtype == torch.bfloat16
    assert all(v.dtype == torch.float32 for v in tm.state_dict().values())
    tm.zero_grad()
    tc, tx = tm(torch.as_tensor(feats), train=True)
    assert tc.dtype == tx.dtype == torch.float32
    (tc.sum() + tx.sum()).backward()
    assert all(p.grad.dtype == torch.float32 for p in tm.parameters())
    # the trunk really computes in bfloat16: its activations differ from the
    # float32 trunk's by more than float32 rounding
    with torch.no_grad():
        tm32 = TDNNF(TdnnfConfig(**SMALL), feats.shape[-1], device="cpu")
        tm32.load_state_dict(tm.state_dict())
        c32, _ = tm32(torch.as_tensor(feats), train=False)
        c16, _ = tm(torch.as_tensor(feats), train=False)
    assert 1e-4 < float((c32 - c16).abs().max()) < 0.2


def _train_forward_grads_and_stats(setup, loose):
    jm, params, stats, tm, feats, w = setup
    wj = jnp.asarray(w)

    def jfn(p):
        (c, x), upd = jm.apply({"params": p, "batch_stats": stats}, jnp.asarray(feats),
                               train=True, mutable=["batch_stats"])
        return jnp.sum(c * wj) + 0.5 * jnp.sum(x * wj), (c, x, upd["batch_stats"])

    (_, (jc, jx, jstats)), jgrad = jax.value_and_grad(jfn, has_aux=True)(params)

    tm.zero_grad()
    tc, tx = tm(torch.as_tensor(feats), train=True)
    (torch.sum(tc * torch.as_tensor(w)) + 0.5 * torch.sum(tx * torch.as_tensor(w))).backward()

    np.testing.assert_allclose(tc.detach().numpy(), np.asarray(jc), atol=1e-5)
    np.testing.assert_allclose(tx.detach().numpy(), np.asarray(jx), atol=1e-5)
    named = dict(tm.named_parameters())
    flat = _flatten(jgrad)
    assert set(flat) == set(named)
    for k, g in flat.items():
        g = np.asarray(g)
        np.testing.assert_allclose(named[k].grad.numpy(), g, rtol=1e-4,
                                   atol=loose.get(k, 1e-5) * np.abs(g).max(), err_msg=k)
    buffers = dict(tm.named_buffers())
    flat_stats = _flatten(jstats)
    assert set(flat_stats) == set(buffers)
    for k, v in flat_stats.items():
        np.testing.assert_allclose(buffers[k].numpy(), np.asarray(v), atol=1e-5, err_msg=k)


def test_params_from_jax_rejects_mismatch(setup):
    _, params, stats, _, _, _ = setup
    bad = dict(params)
    bad.pop("chain_head")
    with pytest.raises(ValueError, match="missing"):
        params_from_jax(bad, stats, TdnnfConfig(**SMALL))
    with pytest.raises(ValueError, match="shape"):
        params_from_jax(params, stats, TdnnfConfig(**{**SMALL, "num_pdfs": 12}))


# -- the plain TDNN and TDNN-F dropout ------------------------------------------


def test_tdnn_matches_jax_on_carried_parameters():
    """The plain TDNN (dilated convolutions, flax's stock batchnorm) against
    the JAX package's TDNN, parameters carried by convert.params_from_jax:
    outputs in eval and train mode, gradients, and the running statistics
    after one train-mode forward; the same tolerances as the TDNN-F's."""
    from torchain_tpu.models import TDNN as JTDNN
    from torchain_tpu.models import TdnnConfig as JTdnnCfg
    from torchain_tpu_torch.models import TDNN, TdnnConfig

    small = dict(num_pdfs=7, hidden_dim=32, prefinal_dim=16,
                 layers=((5, 1, 1), (3, 1, 3), (3, 3, 1)))
    jcfg, tcfg = JTdnnCfg(**small), TdnnConfig(**small)
    assert jcfg.context == tcfg.context
    assert jcfg.frame_subsampling_factor == tcfg.frame_subsampling_factor
    left, right = tcfg.context
    rng = np.random.default_rng(1)
    feats = rng.normal(size=(3, 6 * 3 + left + right, 8)).astype(np.float32)
    jm = JTDNN(jcfg)
    variables = jm.init(jax.random.PRNGKey(2), jnp.asarray(feats), train=False)
    stats = jax.tree.map(
        lambda v: v + jnp.asarray(rng.random(size=v.shape).astype(np.float32)),
        variables["batch_stats"])
    tm = TDNN(tcfg, 8, device="cpu")
    tm.load_state_dict(params_from_jax(variables["params"], stats, tcfg))
    x = torch.tensor(feats)
    w = rng.normal(size=(3, 6, 7)).astype(np.float32)
    (jc, jx) = jm.apply({"params": variables["params"], "batch_stats": stats},
                        jnp.asarray(feats), train=False)
    tc, tx = tm(x, train=False)
    np.testing.assert_allclose(tc.detach().numpy(), np.asarray(jc), atol=1e-5)
    np.testing.assert_allclose(tx.detach().numpy(), np.asarray(jx), atol=1e-5)

    def jloss(p):
        (c, xe), upd = jm.apply({"params": p, "batch_stats": stats}, jnp.asarray(feats),
                                train=True, mutable=["batch_stats"])
        return jnp.sum(c * w) + 0.5 * jnp.sum(xe * w), upd

    (jval, upd), jgrads = jax.value_and_grad(jloss, has_aux=True)(variables["params"])
    tc, tx = tm(x, train=True)
    tval = torch.sum(tc * torch.tensor(w)) + 0.5 * torch.sum(tx * torch.tensor(w))
    tval.backward()
    np.testing.assert_allclose(float(tval.detach()), float(jval), rtol=1e-5)
    named = dict(tm.named_parameters())
    for k, g in _flatten(jax.tree.map(np.asarray, jgrads)).items():
        tol = 1e-5 * float(np.abs(g).max())
        np.testing.assert_allclose(named[k].grad.numpy(), g, rtol=1e-4, atol=tol, err_msg=k)
    buffers = dict(tm.named_buffers())
    for k, v in _flatten(jax.tree.map(np.asarray, upd["batch_stats"])).items():
        np.testing.assert_allclose(buffers[k].numpy(), v, atol=1e-5, err_msg=k)


def test_tdnnf_dropout_rate_zero_and_its_masks(setup):
    """With a rate given the layers take the unfused bypass add (the JAX
    package's order); at rate 0 that meets the fused path to rounding.  A
    rate of 0.2 changes the outputs, and the same generator seed draws the
    same masks."""
    _jm, _params, _stats, tm, feats, _w = setup
    x = torch.tensor(feats)
    with torch.no_grad():
        base = tm(x, train=True)[0]
        zero = tm(x, train=True, dropout_rate=0.0, generator=torch.Generator().manual_seed(1))[0]
        np.testing.assert_allclose(zero.numpy(), base.numpy(), rtol=1e-6, atol=1e-6)
        a = tm(x, train=True, dropout_rate=0.2, generator=torch.Generator().manual_seed(1))[0]
        b = tm(x, train=True, dropout_rate=0.2, generator=torch.Generator().manual_seed(1))[0]
        assert torch.equal(a, b) and not torch.allclose(a, base)
        # eval mode ignores the rate
        ev = tm(x, train=False, dropout_rate=0.2, generator=torch.Generator().manual_seed(1))[0]
        np.testing.assert_allclose(ev.numpy(), tm(x, train=False)[0].numpy(), rtol=1e-6,
                                   atol=1e-6)
