"""The JAX package's alternative trunk lowerings in the PyTorch port, each
against the JAX lowering of the same name and against the port's default
lowering, from the same parameters (convert.params_from_jax):

- TDNN-F (models/tdnn.py): `impl="conv"` (the factors as VALID
  convolutions, the affine adding its own bias before relu and batchnorm),
  `time_major=False` (the "dot" factors over [B, T, C]) and
  `bn_impl="flax"` (flax's stock batchnorm), and all three together;
- the conformer (models/conformer.py): `ln_impl="flax"`, `bn_impl="flax"`,
  `attn_impl="einsum"` (plain matrix products) and `depthwise_impl="conv"`
  (a grouped convolution, a float32 island in a bfloat16 trunk), and all
  four together;

each with a float32 and a bfloat16 trunk, in train mode (both outputs,
the gradient of a fixed scalar of the outputs with respect to every
parameter, the updated running statistics) and in eval mode.

Against the JAX package the tolerances are those of tests/test_torch_tdnn.py
and tests/test_torch_conformer.py for the same trunks (the bfloat16
conformer with XLA's CPU logistic in place of `torch.sigmoid`, as there;
its train-mode outputs under the grouped depthwise convolution to 2e-5,
which sums its taps in another order than XLA's convolution):
TDNN-F float32 outputs and statistics atol 1e-5, each gradient rtol 1e-4
plus 1e-5 of its largest magnitude.  bfloat16: the same for the outputs
and statistics.  Where the layer tail is the fused batchnorm (the
batch-major "dot" trunk) a weight used in bfloat16 gets its gradient as a
bfloat16 product summed over B*T rows, and XLA and torch sum in other
orders, so an element can land one bfloat16 step apart: rtol 2^-7 plus
1e-5 of the largest magnitude; the biases added in bfloat16 3e-2 of their
largest magnitude.  Where it is unfused ("conv", or flax's batchnorm), the
relu and batchnorm chain runs as separate bfloat16 ops in the port, while
XLA's CPU fusions keep float32 between them (its excess-precision
default), so the gradients are held as the bfloat16 conformer's are: 5e-2
of their largest magnitude (2.5e-2 seen).  Against the port's default
lowering on the same weights: float32 eval outputs rel 1e-5 of their
largest magnitude, bfloat16 rel 2e-2 (the lowerings round in other places:
the fused tail adds the bias and takes the relu in float32, flax's
LayerNorm casts its float32 result, the fused one rounds inside, the
grouped convolution is a float32 island; 1e-2 seen).
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import dataclasses

import jax
import jax.numpy as jnp
import torch

from tests.test_torch_conformer import _check_train as _check_conformer_train
from tests.test_torch_conformer import _setup as _conformer_setup
from tests.test_torch_conformer import _xla_cpu_sigmoid
from torchain_tpu.models import TDNNF as JTDNNF
from torchain_tpu.models import TdnnfConfig as JTdnnfCfg
from torchain_tpu_torch.convert import _flatten, params_from_jax
from torchain_tpu_torch.models import TDNNF, Conformer, TdnnfConfig

#: one bfloat16 step, relative to the value (at most)
BF16_STEP = 2.0**-7
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def jax_case(jm, tm, feats, out_shape, seed=0, perturb=0.0):
    """Initialise the flax module `jm` on `feats`, give it non-trivial running
    statistics (and, with `perturb`, parameters moved by that much noise),
    and load the same values into the port's module `tm`.  Returns (jm,
    params, stats, tm, feats, w) with w a fixed weighting of the outputs."""
    rng = np.random.default_rng(seed)
    variables = jm.init(jax.random.PRNGKey(3), jnp.asarray(feats), train=False)
    stats = jax.tree.map(
        lambda v: v + jnp.asarray(rng.random(size=v.shape).astype(np.float32)),
        variables.get("batch_stats", {}))
    params = variables["params"]
    if perturb:
        params = jax.tree.map(
            lambda v: v + jnp.asarray((perturb * rng.normal(size=v.shape)).astype(np.float32)),
            params)
    tm.load_state_dict(params_from_jax(params, stats, tm.config))
    w = rng.normal(size=out_shape).astype(np.float32)
    return jm, params, stats, tm, feats, w


def check_eval(case, atol):
    jm, params, stats, tm, feats, _ = case
    jc, jx = jm.apply({"params": params, "batch_stats": stats}, jnp.asarray(feats), train=False)
    with torch.no_grad():
        tc, tx = tm(torch.as_tensor(feats), train=False)
    assert tc.dtype == tx.dtype == torch.float32
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=atol)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=atol)


def check_train(case, out_atol=1e-5, stat_atol=1e-5, g_rtol=1e-4, g_atol=1e-5, loose=(),
                loose_atol=3e-2):
    """Train-mode outputs, every parameter's gradient of sum(c w) + 0.5
    sum(x w), and the updated statistics, against the JAX module.  A
    gradient is held to rtol `g_rtol` plus `g_atol` of its largest
    magnitude; those whose name ends with one of `loose` to `loose_atol` of
    it.  Returns the largest gradient error relative to each gradient's
    largest magnitude, by name."""
    jm, params, stats, tm, feats, w = case
    wj = jnp.asarray(w)

    def jfn(p):
        (c, x), upd = jm.apply({"params": p, "batch_stats": stats}, jnp.asarray(feats),
                               train=True, mutable=["batch_stats"])
        return jnp.sum(c * wj) + 0.5 * jnp.sum(x * wj), (c, x, upd["batch_stats"])

    (_, (jc, jx, jstats)), jgrad = jax.value_and_grad(jfn, has_aux=True)(params)
    tm.zero_grad()
    tc, tx = tm(torch.as_tensor(feats), train=True)
    (torch.sum(tc * torch.as_tensor(w)) + 0.5 * torch.sum(tx * torch.as_tensor(w))).backward()
    np.testing.assert_allclose(tc.detach().numpy(), np.asarray(jc), atol=out_atol)
    np.testing.assert_allclose(tx.detach().numpy(), np.asarray(jx), atol=out_atol)
    named = dict(tm.named_parameters())
    flat = _flatten(jgrad)
    assert set(flat) == set(named)
    errs = {}
    for k, g in flat.items():
        g = np.asarray(g)
        got = named[k].grad
        assert got is not None and got.dtype == torch.float32, k
        scale = max(float(np.abs(g).max()), 1e-30)
        errs[k] = float(np.abs(got.numpy() - g).max()) / scale
        if k.endswith(loose):
            np.testing.assert_allclose(got.numpy(), g, rtol=0, atol=loose_atol * scale,
                                       err_msg=k)
        else:
            np.testing.assert_allclose(got.numpy(), g, rtol=g_rtol, atol=g_atol * scale,
                                       err_msg=k)
    buffers = dict(tm.named_buffers())
    flat_stats = _flatten(jstats)
    assert set(flat_stats) == set(buffers)
    for k, v in flat_stats.items():
        np.testing.assert_allclose(buffers[k].numpy(), np.asarray(v), atol=stat_atol, err_msg=k)
    return errs


def check_same_as(tm, default_cls, feats, rel):
    """Eval outputs of `tm` against a model of `default_cls` under the
    default lowerings holding `tm`'s weights, within `rel` of their largest
    magnitude."""
    cfg = tm.config
    defaults = {f.name: f.default for f in dataclasses.fields(cfg)
                if f.name in ("impl", "time_major", "bn_impl", "ln_impl", "attn_impl",
                              "depthwise_impl")}
    base = default_cls(dataclasses.replace(cfg, **defaults), feats.shape[-1], device="cpu")
    base.load_state_dict(tm.state_dict())
    with torch.no_grad():
        a, b = tm(torch.as_tensor(feats), train=False), base(torch.as_tensor(feats), train=False)
    for x, y in zip(a, b):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=0,
                                   atol=rel * float(y.abs().max()))
    return base


# -- TDNN-F --------------------------------------------------------------------

TDNNF_SMALL = dict(num_pdfs=11, hidden_dim=64, bottleneck_dim=16, prefinal_dim=32, num_layers=3)
B, T_OUT, FEAT = 3, 6, 8
TDNNF_LOWERINGS = {
    "conv": dict(impl="conv"),
    "batch_major": dict(time_major=False),
    "flax_bn": dict(bn_impl="flax"),
    "conv_flax_bn": dict(impl="conv", bn_impl="flax"),
}
#: biases added in bfloat16: their gradient is a bfloat16 sum over B*T rows
BF16_SUMMED = ("input_proj.bias", "chain_head.Dense_0.bias", "xent_head.Dense_0.bias",
               "affine.bias")


@pytest.fixture(scope="module",
                params=[(v, d) for v in TDNNF_LOWERINGS for d in DTYPES],
                ids=lambda p: f"{p[0]}-{p[1]}")
def tdnnf_case(request):
    variant, dtype = request.param
    jd, td = DTYPES[dtype]
    jcfg = JTdnnfCfg(dtype=jd, **TDNNF_SMALL, **TDNNF_LOWERINGS[variant])
    tcfg = TdnnfConfig(dtype=td, **TDNNF_SMALL, **TDNNF_LOWERINGS[variant])
    assert jcfg.context == tcfg.context
    left, right = tcfg.context
    feats = np.random.default_rng(1).normal(
        size=(B, T_OUT * 3 + left + right, FEAT)).astype(np.float32)
    case = jax_case(JTDNNF(jcfg), TDNNF(tcfg, FEAT, device="cpu"), feats,
                    (B, T_OUT, TDNNF_SMALL["num_pdfs"]), perturb=0.05)
    return case, dtype


def test_tdnnf_lowering_eval_matches_jax(tdnnf_case):
    case, _ = tdnnf_case
    check_eval(case, atol=1e-5)


def test_tdnnf_lowering_train_matches_jax(tdnnf_case):
    case, dtype = tdnnf_case
    if dtype == "float32":
        check_train(case)
    elif case[3].tdnnf1.fuse_post:
        check_train(case, g_rtol=BF16_STEP, loose=BF16_SUMMED)
    else:
        check_train(case, g_rtol=0.0, g_atol=5e-2)


def test_tdnnf_lowering_equals_the_default(tdnnf_case):
    case, dtype = tdnnf_case
    check_same_as(case[3], TDNNF, case[4], 1e-5 if dtype == "float32" else 2e-2)


def test_tdnnf_conv_lowering_applies_the_affine_bias_itself():
    """Under "conv" the affine holds and adds its own bias (no deferred
    bias), the trunk runs [B, T, C], and the parameter tree is unchanged."""
    conv = TDNNF(TdnnfConfig(impl="conv", **TDNNF_SMALL), FEAT, device="cpu")
    dot = TDNNF(TdnnfConfig(**TDNNF_SMALL), FEAT, device="cpu")
    assert {k: v.shape for k, v in conv.state_dict().items()} == {
        k: v.shape for k, v in dot.state_dict().items()}
    assert not conv.time_major and not conv.tdnnf1.fuse_post and dot.tdnnf1.fuse_post
    with pytest.raises(ValueError, match="not ported"):
        TdnnfConfig(impl="scan")


# -- the conformer -------------------------------------------------------------

CONFORMER_LOWERINGS = {
    "flax_ln": dict(ln_impl="flax"),
    "flax_bn": dict(bn_impl="flax"),
    "einsum": dict(attn_impl="einsum"),
    "depthwise_conv": dict(depthwise_impl="conv"),
    "all": dict(ln_impl="flax", bn_impl="flax", attn_impl="einsum", depthwise_impl="conv"),
}


@pytest.fixture(scope="module",
                params=[(v, d) for v in CONFORMER_LOWERINGS for d in DTYPES],
                ids=lambda p: f"{p[0]}-{p[1]}")
def conformer_case(request):
    variant, dtype = request.param
    bf16 = dtype == "bfloat16"
    return (*_conformer_setup(bf16, **CONFORMER_LOWERINGS[variant]), bf16)


def test_conformer_lowering_eval_matches_jax(conformer_case, monkeypatch):
    *case, bf16 = conformer_case
    if bf16:
        monkeypatch.setattr(torch, "sigmoid", _xla_cpu_sigmoid)
    check_eval(case, atol=1e-5)


def test_conformer_lowering_train_matches_jax(conformer_case, monkeypatch):
    # the grouped convolution sums its taps in another order than XLA's
    # convolution: the train-mode outputs to 2e-5 (1.07e-5 seen), all else
    # at test_torch_conformer.py's tolerances
    grouped = conformer_case[3].config.depthwise_impl == "conv"
    _check_conformer_train(conformer_case, monkeypatch, out_atol=2e-5 if grouped else 1e-5)


def test_conformer_lowering_equals_the_default(conformer_case, monkeypatch):
    *case, bf16 = conformer_case
    if bf16:
        monkeypatch.setattr(torch, "sigmoid", _xla_cpu_sigmoid)
    check_same_as(case[3], Conformer, case[4], 2e-2 if bf16 else 1e-5)


def test_einsum_attention_launches_no_attention_kernel(monkeypatch):
    """Under attn_impl="einsum" the block never calls the fused attention
    (K7f/K7b's wrapper); the depthwise "conv" lowering keeps its float32
    island in a bfloat16 trunk without depthwise_f32."""
    from torchain_tpu_torch.models import conformer as conf

    def refuse(*a, **k):
        raise AssertionError("fused attention called")

    monkeypatch.setattr(conf, "fused_relpos_attention", refuse)
    *case, _ = _conformer_setup(True, attn_impl="einsum", depthwise_impl="conv")
    tm = case[3]
    assert all(getattr(tm, f"block{i}").dw_dtype == torch.float32 for i in range(2))
    with torch.no_grad():
        tm(torch.as_tensor(case[4]), train=False)


def cli_cut_and_resume(tmp_path, model: str, optimizer: str, steps: int = 6, cut: int = 3):
    """`cli.train --synthetic --device cpu` for `steps` steps at a constant
    learning rate, and the same run cut after `cut` steps and resumed from
    its checkpoint: the loss falls, and the resumed run's metrics, final
    parameters, statistics and optimizer state are bit-equal to the uncut
    run's.  Returns the uncut run's metric lines."""
    import json

    from torchain_tpu_torch.cli.train import main as train_main

    def run(d, n):
        out = tmp_path / f"{d}.jsonl"
        res = train_main(["--synthetic", "--device", "cpu", "--model", model, "--optimizer",
                          optimizer, "--hidden-dim", "32", "--bottleneck-dim", "8",
                          "--num-layers", "3", "--num-utts", "16", "--batch-size", "4",
                          "--chunk-frames", "8", "--epochs", "4", "--steps", str(n),
                          "--log-every", "1", "--lr", "3e-3", "--checkpoint-dir",
                          str(tmp_path / d), "--metrics-out", str(out)])
        lines = [json.loads(x) for x in out.read_text().splitlines()]
        return res, lines

    res, whole = run("whole", steps)
    assert res["steps"] == steps and len(whole) == steps
    losses = [m["loss"] for m in whole]
    assert all(np.isfinite(losses)) and min(losses[steps // 2:]) < losses[0], losses
    run("cut", cut)
    res2, tail = run("cut", steps)
    assert res2["timings"]["ckpt_read"] and [m["step"] for m in tail] == list(
        range(cut + 1, steps + 1))
    assert [m["loss"] for m in tail] == losses[cut:]
    a = torch.load(tmp_path / "whole" / str(steps) / "state.pt", weights_only=True)
    b = torch.load(tmp_path / "cut" / str(steps) / "state.pt", weights_only=True)
    assert a["model"].keys() == b["model"].keys()
    assert all(torch.equal(v, b["model"][k]) for k, v in a["model"].items())

    def tensors(x):
        if isinstance(x, torch.Tensor):
            return [x]
        if isinstance(x, dict):
            return [t for v in x.values() for t in tensors(v)]
        if isinstance(x, (list, tuple)):
            return [t for v in x for t in tensors(v)]
        return []

    ta, tb = tensors(a["optimizer"]), tensors(b["optimizer"])
    assert len(ta) == len(tb) > 0 and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(ta, tb))
    return whole
