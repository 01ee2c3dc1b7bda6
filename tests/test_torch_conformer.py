"""Conformer of the PyTorch port (models/conformer.py, with ops/fused_ln.py,
ops/attention.py, ops/fused_ffn.py) against the JAX package's flax
Conformer, from the same parameters carried over by
convert.params_from_jax: a 2-block model (dim 32, 2 heads, B=2, T_out=7) in
train and eval mode: both outputs, the gradient of a fixed scalar of the
outputs with respect to every parameter, and the updated batchnorm
running statistics; with `ffn_impl` dense and fused, `depthwise_f32` both
ways, float32 and bfloat16 trunks.  The JAX side runs its attention kernels
in interpret mode and, on the CPU, its fused FFN through its plain
reference.

Tolerance, float32 trunk: atol 1e-5 on outputs and statistics; on each
gradient rtol 1e-4 plus an atol of 5e-5 times that gradient's largest
magnitude (float32 sums in another order through two blocks of LayerNorm
and a batchnorm over 14 rows; 2e-5 seen).  The relative-position table's gradient is a scatter-add of
H*T*T entries into 65 rows, summed in another order than JAX's, and is held
the same way.

Tolerance, bfloat16 trunk.  One op differs by construction: XLA's CPU
lowering of a bfloat16 logistic rounds the exp, the add and the divide each
to bfloat16, `torch.sigmoid` computes in float32 and rounds once, and 35%
of the sigmoid values then differ by one bfloat16 step, which two blocks
and a batchnorm over 14 rows amplify (outputs to 7e-2, single gradients
beyond their own size).  So the bfloat16 cases run the port with
`torch.sigmoid` replaced by XLA's three-rounding form, which shows that
every other cast sits where the JAX package has it: outputs and statistics
atol 1e-5 (4e-7 seen), each gradient within 5e-2 of its largest magnitude
(2.7e-2 seen: bias gradients are bfloat16 sums over B*T rows, rounded at
other places).  One case keeps `torch.sigmoid` and holds the eval outputs
to atol 5e-2 (1.6e-2 seen)."""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax
import jax.numpy as jnp
import torch

from torchain_tpu.models import Conformer as JConformer
from torchain_tpu.models import ConformerConfig as JCfg
from torchain_tpu_torch.convert import _flatten, params_from_jax
from torchain_tpu_torch.models import Conformer, ConformerConfig, TdnnfConfig, continuous_dropout

SMALL = dict(num_pdfs=11, dim=32, num_layers=2, num_heads=2, prefinal_dim=16)
B, T_OUT, FEAT = 2, 7, 8

VARIANTS = {
    "dense": {},
    "fused_ffn": dict(ffn_impl="fused"),
    "depthwise_f32": dict(depthwise_f32=True),
}


def _xla_cpu_sigmoid(x):
    """XLA's CPU lowering of a logistic: exp, add and divide as separate ops,
    each rounded to x.dtype."""
    return 1.0 / (1.0 + torch.exp(-x))


def _setup(bf16, config=SMALL, **kw):
    jcfg = JCfg(dtype=jnp.bfloat16 if bf16 else jnp.float32, **config, **kw)
    tcfg = ConformerConfig(dtype=torch.bfloat16 if bf16 else torch.float32, **config, **kw)
    assert jcfg.context == tcfg.context
    left, right = tcfg.context
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(B, T_OUT * 3 + left + right, FEAT)).astype(np.float32)
    jm = JConformer(jcfg)
    variables = jm.init(jax.random.PRNGKey(3), jnp.asarray(feats), train=False)
    # non-trivial running statistics, biases and LayerNorm parameters, so
    # that every parameter matters in both modes
    stats = jax.tree.map(
        lambda v: v + jnp.asarray(rng.random(size=v.shape).astype(np.float32)),
        variables["batch_stats"],
    )
    params = jax.tree.map(
        lambda v: v + jnp.asarray((0.05 * rng.normal(size=v.shape)).astype(np.float32)),
        variables["params"],
    )
    tm = Conformer(tcfg, FEAT, device="cpu")
    tm.load_state_dict(params_from_jax(params, stats, tcfg))
    w = rng.normal(size=(B, T_OUT, config["num_pdfs"])).astype(np.float32)
    return jm, params, stats, tm, feats, w


# (depthwise_f32 changes nothing in a float32 trunk)
@pytest.fixture(scope="module",
                params=[(v, b) for v in VARIANTS for b in (False, True)
                        if b or v != "depthwise_f32"],
                ids=lambda p: f"{p[0]}-{'bfloat16' if p[1] else 'float32'}")
def setup(request):
    variant, bf16 = request.param
    return (*_setup(bf16, **VARIANTS[variant]), bf16)


def test_eval_forward_matches(setup, monkeypatch):
    jm, params, stats, tm, feats, _, bf16 = setup
    if bf16:
        monkeypatch.setattr(torch, "sigmoid", _xla_cpu_sigmoid)
    jc, jx = jm.apply({"params": params, "batch_stats": stats}, jnp.asarray(feats), train=False)
    with torch.no_grad():
        tc, tx = tm(torch.as_tensor(feats), train=False)
    assert tc.dtype == tx.dtype == torch.float32 and tc.shape == (B, T_OUT, SMALL["num_pdfs"])
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-5)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-5)


def test_bf16_eval_forward_with_torch_sigmoid_stays_close():
    jm, params, stats, tm, feats, _ = _setup(True)
    jc, jx = jm.apply({"params": params, "batch_stats": stats}, jnp.asarray(feats), train=False)
    with torch.no_grad():
        tc, tx = tm(torch.as_tensor(feats), train=False)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=5e-2)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=5e-2)
    assert float(np.abs(tc.numpy() - np.asarray(jc)).max()) > 1e-5


def test_train_forward_grads_and_stats_match(setup, monkeypatch):
    _check_train(setup, monkeypatch)


def _check_train(setup, monkeypatch, out_atol=1e-5, stat_atol=1e-5):
    jm, params, stats, tm, feats, w, bf16 = setup
    if bf16:
        monkeypatch.setattr(torch, "sigmoid", _xla_cpu_sigmoid)
    wj = jnp.asarray(w)

    def jfn(p):
        (c, x), upd = jm.apply({"params": p, "batch_stats": stats}, jnp.asarray(feats),
                               train=True, mutable=["batch_stats"])
        return jnp.sum(c * wj) + 0.5 * jnp.sum(x * wj), (c, x, upd["batch_stats"])

    (_, (jc, jx, jstats)), jgrad = jax.value_and_grad(jfn, has_aux=True)(params)

    tm.zero_grad()
    tc, tx = tm(torch.as_tensor(feats), train=True)
    (torch.sum(tc * torch.as_tensor(w)) + 0.5 * torch.sum(tx * torch.as_tensor(w))).backward()

    g_rtol, g_atol = (0.0, 5e-2) if bf16 else (1e-4, 5e-5)
    np.testing.assert_allclose(tc.detach().numpy(), np.asarray(jc), atol=out_atol)
    np.testing.assert_allclose(tx.detach().numpy(), np.asarray(jx), atol=out_atol)
    named = dict(tm.named_parameters())
    flat = _flatten(jgrad)
    assert set(flat) == set(named)
    for k, g in flat.items():
        g = np.asarray(g)
        assert named[k].grad is not None and named[k].grad.dtype == torch.float32, k
        if k.endswith("depthwise.bias"):
            # a per-channel constant in front of a train-mode batchnorm: the
            # true gradient is 0 and both sides hold only rounding noise
            # (of bfloat16 sums, where the taps run in bfloat16)
            noise = 1e-4 if tm.config.dtype == torch.float32 or tm.config.depthwise_f32 else 1.0
            assert np.abs(named[k].grad.numpy()).max() <= noise, k
            assert np.abs(g).max() <= noise, k
            continue
        np.testing.assert_allclose(named[k].grad.numpy(), g, rtol=g_rtol,
                                   atol=g_atol * np.abs(g).max(), err_msg=k)
    buffers = dict(tm.named_buffers())
    flat_stats = _flatten(jstats)
    assert set(flat_stats) == set(buffers)
    for k, v in flat_stats.items():
        np.testing.assert_allclose(buffers[k].numpy(), np.asarray(v), atol=stat_atol, err_msg=k)


def test_wide_heads_train_forward_grads_and_stats_match(monkeypatch):
    """A conformer of dim 384 with 4 heads of 96 (the kernels' 96-wide
    tiles), one block, float32: the train-mode forward, every gradient and
    the statistics against the JAX package to the float32 tolerances, but
    for the outputs, atol 5e-5: their sums run over 384- and 1536-wide rows,
    12 and 48 times the 32-wide model's (1.3e-5 seen)."""
    wide = dict(SMALL, dim=384, num_heads=4, num_layers=1)
    _check_train((*_setup(False, config=wide), False), monkeypatch, out_atol=5e-5)


@pytest.mark.parametrize("bf16", [False, True], ids=["float32", "bfloat16"])
def test_fused_ffn_conformer_past_the_kernels_width_matches(monkeypatch, bf16):
    """A conformer of dim 512 with the fused feed-forward (F 2048, past one
    K10 block's 384 output columns: the kernels cut such rows into column
    groups), one block: the train-mode forward, every gradient and the
    statistics against the JAX package.  float32: the
    tolerances of the 384-wide model above (outputs atol 5e-5).  bfloat16:
    outputs atol 5e-2, as the bfloat16 case with `torch.sigmoid` above: at
    this width XLA's CPU products of bfloat16 operands put 0.3% of the
    feed-forward's outputs one bfloat16 step from the port's (sums of 2048
    products in another order), and the block carries that to 1e-2 (the
    dense lowering at this width differs as much); gradients as the
    bfloat16 cases above; the batchnorm statistics atol 1e-4 (a running
    mean moves by a hundredth of the batch mean over those outputs: 2.8e-5
    seen)."""
    wide = dict(SMALL, dim=512, num_heads=4, num_layers=1)
    jm, params, stats, tm, feats, w = _setup(bf16, config=wide, ffn_impl="fused")
    assert tm.block0.ffn1_in.kernel.shape == (512, 2048)
    _check_train((jm, params, stats, tm, feats, w, bf16), monkeypatch,
                 out_atol=5e-2 if bf16 else 5e-5, stat_atol=1e-4 if bf16 else 1e-5)


def test_bf16_trunk_really_computes_in_bfloat16():
    *_, tm, feats, _ = _setup(True)
    assert all(v.dtype == torch.float32 for v in tm.state_dict().values())
    with torch.no_grad():
        tm32 = Conformer(ConformerConfig(**SMALL), FEAT, device="cpu")
        tm32.load_state_dict(tm.state_dict())
        c32, _ = tm32(torch.as_tensor(feats), train=False)
        c16, _ = tm(torch.as_tensor(feats), train=False)
    assert 1e-4 < float((c32 - c16).abs().max()) < 0.5


def test_ffn_lowerings_share_parameters_and_agree():
    *_, tm, feats, _ = _setup(False)
    fused = Conformer(ConformerConfig(ffn_impl="fused", **SMALL), FEAT, device="cpu")
    fused.load_state_dict(tm.state_dict())
    with torch.no_grad():
        a, _ = tm(torch.as_tensor(feats), train=False)
        b, _ = fused(torch.as_tensor(feats), train=False)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)


def test_params_from_jax_rejects_mismatch():
    _, params, stats, *_ = _setup(False)
    cfg = ConformerConfig(**SMALL)
    bad = dict(params)
    bad.pop("rel_pos")
    with pytest.raises(ValueError, match="missing"):
        params_from_jax(bad, stats, cfg)
    with pytest.raises(ValueError, match="extra"):
        params_from_jax({**params, "block2": params["block1"]}, stats, cfg)
    with pytest.raises(ValueError, match="shape"):
        params_from_jax(params, stats, ConformerConfig(**{**SMALL, "num_pdfs": 12}))
    # a conformer tree is not a TDNN-F tree
    with pytest.raises(ValueError, match="missing"):
        params_from_jax(params, stats, TdnnfConfig())
    with pytest.raises(TypeError):
        params_from_jax(params, stats, SMALL)


@pytest.mark.parametrize("kernel,want", [(5, (2, 2)), (7, (3, 3)), (3, (1, 1))])
def test_context_arithmetic(kernel, want):
    tcfg = ConformerConfig(frontend_kernel=kernel, **SMALL)
    assert tcfg.context == JCfg(frontend_kernel=kernel, **SMALL).context == want
    left, right = tcfg.context
    m = Conformer(tcfg, FEAT, device="cpu")
    with torch.no_grad():
        c, _ = m(torch.zeros(1, T_OUT * 3 + left + right, FEAT))
    assert c.shape[1] == T_OUT


@pytest.mark.parametrize("field", ["ln_impl", "bn_impl", "depthwise_impl", "attn_impl", "ffn_impl"])
def test_unported_lowerings_are_refused(field):
    """Every lowering of the JAX package is ported (tests/test_torch_lowerings.py);
    a value that names none of them is refused."""
    with pytest.raises(ValueError, match="not ported"):
        ConformerConfig(**{field: "xla"})


def test_continuous_dropout_identity_cases_and_mask_shape():
    x = torch.ones(3, 5, 4)
    gen = torch.Generator().manual_seed(0)
    assert continuous_dropout(x, 0.2, False, gen) is x
    assert continuous_dropout(x, None, True, gen) is x
    assert continuous_dropout(x, 0.2, True, None) is x
    y = continuous_dropout(x, 0.2, True, gen)
    # one factor per (utterance, channel), shared over time, in [1-2p, 1+2p]
    assert y.shape == x.shape and torch.equal(y, y[:, :1].expand_as(y))
    assert float(y.min()) >= 0.6 and float(y.max()) <= 1.4 and y.unique().numel() == 12
    yt = continuous_dropout(x, 0.2, True, gen, time_axis=0)
    assert torch.equal(yt, yt[:1].expand_as(yt))
    assert torch.equal(continuous_dropout(x, 0.0, True, gen), x)
    # the model passes it through: with a generator the training outputs move
    m = Conformer(ConformerConfig(**SMALL), FEAT, device="cpu")
    feats = torch.randn(B, T_OUT * 3 + 4, FEAT, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        plain, _ = m(feats, train=True)
        same, _ = m(feats, train=True, dropout_rate=0.3)
        moved, _ = m(feats, train=True, dropout_rate=0.3, generator=gen)
    assert torch.equal(plain, same) and not torch.equal(plain, moved)
