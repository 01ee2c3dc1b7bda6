"""The CNN-TDNN of the PyTorch port (models/cnn.py) against the JAX package's
(torchain_tpu/models/cnn.py) on the CPU, from the same parameters
(convert.params_from_jax):

- one conv block at 40 and at 41 mel bins with frequency stride 2: the
  JAX module pads frequency by (freq_kernel - 1) // 2 = 1 bin on each side
  (its nn.Conv padding ((0, 0), (1, 1))), giving 20 and 21 bins.  That is
  not flax's "SAME": at 40 bins SAME pads 0 before and 1 after (the same
  20 bins, shifted by one), and the test shows the JAX module's output
  differs from it there; at 41 bins SAME pads 1 and 1 and they agree;
- the whole model (3 small conv blocks, 40 -> 40 -> 20 -> 10 bins, then 3
  factored layers) at 40 bins with a float32 and a bfloat16 trunk and at
  41 bins in float32: train mode (both outputs, every parameter's
  gradient, the running statistics) and eval mode.

Tolerances: float32 outputs and statistics atol 1e-5, each gradient rtol
1e-4 plus 1e-5 of its largest magnitude (tests/test_torch_tdnn.py's);
bfloat16 outputs and statistics the same, gradients within 5e-2 of their
largest magnitude (the bfloat16 conformer's bound; 5.1e-3 seen), but for
the conv blocks' biases: each is a bfloat16 sum over B*T*F positions ahead
of a relu and a batchnorm, whose rounding noise is of the order of the
gradient itself (the JAX package's own bfloat16 gradient of conv0's bias
sits 3.1 away from its float32 one, at a largest magnitude of 9.8), and the
port's is held within twice the distance of the JAX bfloat16 gradient from
the JAX float32 one (1.08x seen, on conv1's bias).
"""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")

import flax.linen as fnn
import jax
import jax.numpy as jnp
import torch

from tests.test_torch_lowerings import DTYPES, check_eval, check_train, cli_cut_and_resume, jax_case
from torchain_tpu.models import CNNTDNN as JCNNTDNN
from torchain_tpu.models import CnnTdnnConfig as JCfg
from torchain_tpu_torch.models import CNNTDNN, CnnTdnnConfig
from torchain_tpu_torch.models.cnn import ConvBlock

SMALL = dict(num_pdfs=9, conv_filters=(4, 4, 6), conv_freq_strides=(1, 2, 2), hidden_dim=24,
             bottleneck_dim=6, prefinal_dim=8, num_tdnnf_layers=3)
B, T_OUT = 2, 4
CONV_BIASES = ("conv0.bias", "conv1.bias", "conv2.bias")


@pytest.mark.parametrize("bins,want", [(40, 20), (41, 21)])
def test_frequency_padding_is_the_jax_modules(bins, want):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 7, bins, 3)).astype(np.float32)
    jconv = fnn.Conv(5, kernel_size=(3, 3), strides=(1, 2), padding=((0, 0), (1, 1)))
    params = jconv.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    params = jax.tree.map(lambda v: v + 0.1, params)
    want_y = np.asarray(jconv.apply({"params": params}, jnp.asarray(x)))
    block = ConvBlock(3, 5, 3, 3, 2, 1, device="cpu")
    block.load_state_dict({k: torch.tensor(np.asarray(v)) for k, v in params.items()})
    with torch.no_grad():
        got = block(torch.as_tensor(x)).numpy()
    assert got.shape == want_y.shape == (2, 5, want, 5)
    np.testing.assert_allclose(got, want_y, atol=1e-5)
    # flax "SAME" along frequency: total = max((out - 1) * s + k - in, 0),
    # total // 2 before
    total = max((want - 1) * 2 + 3 - bins, 0)
    assert (total // 2, total - total // 2) == ((0, 1) if bins == 40 else (1, 1))
    same = fnn.Conv(5, kernel_size=(3, 3), strides=(1, 2),
                    padding=((0, 0), (total // 2, total - total // 2)))
    same_y = np.asarray(same.apply({"params": params}, jnp.asarray(x)))
    assert same_y.shape == want_y.shape
    assert np.allclose(same_y, want_y, atol=1e-5) == (bins % 2 == 1)


@pytest.fixture(scope="module",
                params=[("float32", 40), ("bfloat16", 40), ("float32", 41)],
                ids=lambda p: f"{p[0]}-{p[1]}bins")
def case(request):
    dtype, bins = request.param
    jd, td = DTYPES[dtype]
    jcfg = JCfg(dtype=jd, feat_dim=bins, **SMALL)
    tcfg = CnnTdnnConfig(dtype=td, feat_dim=bins, **SMALL)
    assert jcfg.context == tcfg.context and jcfg.conv_out_dim == tcfg.conv_out_dim
    left, right = tcfg.context
    feats = np.random.default_rng(3).normal(
        size=(B, T_OUT * 3 + left + right, bins)).astype(np.float32)
    return jax_case(JCNNTDNN(jcfg), CNNTDNN(tcfg, bins, device="cpu"), feats,
                    (B, T_OUT, SMALL["num_pdfs"]), perturb=0.05), dtype


def test_cnn_tdnn_eval_matches_jax(case):
    check_eval(case[0], atol=1e-5)


def test_cnn_tdnn_train_matches_jax(case):
    c, dtype = case
    if dtype == "float32":
        check_train(c)
        return
    errs = check_train(c, g_rtol=0.0, g_atol=5e-2, loose=CONV_BIASES, loose_atol=np.inf)
    # the conv blocks' biases in bfloat16: each is a bfloat16 sum over
    # B*T*F positions ahead of a relu and a batchnorm, and its rounding noise
    # is of the order of the gradient itself; the port must sit within
    # twice the distance of the JAX package's bfloat16 gradient from its own
    # float32 gradient on the same weights
    jm, params, stats, tm, feats, w = c
    j32 = JCNNTDNN(dataclasses.replace(jm.config, dtype=jnp.float32))
    wj = jnp.asarray(w)

    def grads(model):
        def fn(p):
            (ch, x), _ = model.apply({"params": p, "batch_stats": stats}, jnp.asarray(feats),
                                     train=True, mutable=["batch_stats"])
            return jnp.sum(ch * wj) + 0.5 * jnp.sum(x * wj)
        return jax.grad(fn)(params)

    g16, g32 = grads(jm), grads(j32)
    named = dict(tm.named_parameters())
    for k in CONV_BIASES:
        a, b, ref = (np.asarray(g16[k.split(".")[0]]["bias"]), named[k].grad.numpy(),
                     np.asarray(g32[k.split(".")[0]]["bias"]))
        assert np.abs(b - a).max() <= 2 * np.abs(a - ref).max(), (k, errs[k])


def test_conv_out_dim_and_layout():
    """40 bins step down 40 -> 20 -> 10 under the default strides, the
    flattened plane is [bins, channels] frequency major, the kernels are
    HWIO, and a feature dimension other than the config's is refused."""
    cfg = CnnTdnnConfig()
    assert cfg.conv_out_dim == JCfg().conv_out_dim == 10 * 128
    assert cfg.context == JCfg().context
    m = CNNTDNN(CnnTdnnConfig(**SMALL), device="meta")
    sd = m.state_dict()
    assert sd["conv0.kernel"].shape == (3, 3, 1, 4) and sd["conv2.kernel"].shape == (3, 3, 4, 6)
    assert sd["input_proj.kernel"].shape == (10 * 6, 24) and "conv_bn1.var" in sd
    with pytest.raises(ValueError, match="feat_dim"):
        CNNTDNN(CnnTdnnConfig(**SMALL), 24, device="meta")


@pytest.mark.parametrize("optimizer", ["adam-lowmem", "ngsgd"])
def test_train_cli_cnn_tdnn_cut_and_resume_bit_equal(tmp_path, optimizer):
    cli_cut_and_resume(tmp_path, "cnn-tdnn", optimizer)
