"""The training path as a whole: three chain training steps of a small
TDNN-F, and of a small conformer, on the same batch, with the JAX package's
make_train_step (resident
denominator kernels in interpret mode; the numerator as XLA scan,
TORCHAIN_NUM_RESIDENT=0, and as resident Pallas kernels in interpret mode,
=force) and with the port's make_train_step, from the same parameters
(convert.params_from_jax).

Tolerance, float32 trunk: rtol 1e-4 on every per-step metric; after step 3,
atol 1e-5 on the parameters and the batchnorm statistics.  Parameter
elements whose step-1 gradient is below 1e-6 in magnitude are left out:
there Adam's g / (|g| + eps) turns float32 rounding of g into a different
step.

Tolerance, bfloat16 trunk: the two frameworks round bfloat16 sums at other
places (tests/test_torch_tdnn.py), and Adam turns a gradient element whose
sign differs into a step of the full learning rate the other way, 1e-3 per
step.  Metrics rtol 2e-2 (6.6e-3 seen); parameters (float32 on both sides) atol 6e-3, the
most three steps can part them (3.9e-3 seen), and at least 60% of their
elements within 1e-4 (79% seen; the median difference is 4e-5); statistics
atol 2e-3 (5.5e-4 seen).

The conformer (2 blocks, dim 32, 2 heads; attention kernels in interpret
mode on the JAX side) is held to the same tolerances, with the dense and
the fused feed-forward, but for two things that follow from the depthwise
bias, which sits in front of a train-mode batchnorm and so has a true
gradient of 0: it is left out like every element with a tiny step-1
gradient, and the running means of those batchnorms, which follow it, get
atol 1e-4; float32 parameters get atol 3e-5.  The bfloat16 case replaces
`torch.sigmoid` by XLA's CPU form of a bfloat16 logistic (exp, add and
divide each rounded), as tests/test_torch_conformer.py explains, and
compiles the JAX step with `xla_allow_excess_precision` off.

Two further paths train the same small float32 TDNN-F to the float32
tolerances: flat-start (e2e) supervision from E2eChainDataset with the
resident denominator, under both numerator configurations of the JAX
package, and the standard supervision with the dense Moore denominator
(ops/den_dense.py and, `fused`, the plain versions of K9f/K9b in
ops/den_pallas.py; the JAX side runs den_dense, which off its accelerator is
the only form its dispatcher picks)."""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax
import jax.numpy as jnp
import optax
import torch

import torchain_tpu.data as jdata
import torchain_tpu.graphs as jgraphs
import torchain_tpu_torch.data as tdata
import torchain_tpu_torch.graphs as tgraphs
from torchain_tpu.models import Conformer as JConformer
from torchain_tpu.models import ConformerConfig as JConformerCfg
from torchain_tpu.models import TDNNF as JTDNNF
from torchain_tpu.models import TdnnfConfig as JCfg
from torchain_tpu.ops import ChainLossOptions as JOpts
from torchain_tpu.ops.den_resident import DeviceResidentDenGraph as JResident
from torchain_tpu.ops.device_graphs import DeviceSupervision as JSup
from torchain_tpu.train import create_train_state as j_create
from torchain_tpu.train import make_train_step as j_make_step
from torchain_tpu_torch.convert import _flatten, params_from_jax
from torchain_tpu_torch.models import TDNNF, Conformer, ConformerConfig, TdnnfConfig
from torchain_tpu_torch.ops import ChainLossOptions, DeviceSupervision, auto_den_graph
from torchain_tpu_torch.train import create_train_state, make_train_step

CORPUS = dict(num_utts=6, num_phones=4, feat_dim=8, utt_frames_out=(7, 9), seed=2)
SMALL = dict(hidden_dim=64, bottleneck_dim=16, prefinal_dim=32, num_layers=3)
OPTS = dict(l2_regularize=5e-4, leaky_hmm_coefficient=0.1, xent_regularize=0.1)
SMALL_CONFORMER = dict(dim=32, num_layers=2, num_heads=2, prefinal_dim=16)
B, T_OUT, STEPS = 3, 6, 3


def _batch(pkg_data, pkg_graphs, cfg):
    c = pkg_data.synthetic_dataset(**CORPUS)
    left, right = cfg.context
    ds = pkg_data.ChainDataset(
        c.utts, c.tree, c.norm_fst, chunk_frames_out=T_OUT, left_context=left,
        right_context=right,
        sup_opts=pkg_graphs.SupervisionOptions(left_tolerance=2, right_tolerance=2),
    )
    return c, next(ds.batches(B, shuffle=False))


def _e2e_batch(pkg_data, pkg_graphs, cfg):
    c = pkg_data.synthetic_dataset(**CORPUS)
    left, right = cfg.context
    ds = pkg_data.E2eChainDataset(c.utts, c.tree, c.norm_fst, chunk_frames_out=T_OUT,
                                  left_context=left, right_context=right)
    return c, next(ds.batches(B, shuffle=False))


@pytest.mark.parametrize("resident", ["0", "force"])
def test_three_e2e_train_steps_match_jax(monkeypatch, resident):
    from torchain_tpu.ops.num_e2e import DeviceE2eSupervision as JE2e
    from torchain_tpu_torch.ops import DeviceE2eSupervision

    _three_train_steps(
        monkeypatch, resident, batch_fn=_e2e_batch,
        sups=(lambda b: JE2e.from_host(b.sup),
              lambda b: DeviceE2eSupervision.from_host(b.sup, device="cpu").with_kernel_tables()),
    )


@pytest.mark.parametrize("fused", [False, True], ids=["den_dense", "fused"])
def test_three_dense_denominator_train_steps_match_jax(monkeypatch, fused):
    from torchain_tpu.ops.device_graphs import DeviceDenseDenGraph as JDense
    from torchain_tpu_torch.ops import DeviceDenseDenGraph

    _three_train_steps(
        monkeypatch, "force",
        dens=(lambda c: JDense.from_host(jgraphs.make_dense_den_graph(c.den_graph, pad_to=8)),
              lambda c: DeviceDenseDenGraph.from_host(
                  tgraphs.make_dense_den_graph(c.den_graph, pad_to=8), device="cpu",
                  fused=fused)),
    )


def test_three_train_steps_match_jax(monkeypatch):
    _three_train_steps(monkeypatch, "0")


def test_three_train_steps_match_jax_resident_numerator(monkeypatch):
    _three_train_steps(monkeypatch, "force")


@pytest.mark.parametrize("resident", ["0", "force"])
def test_three_train_steps_bf16_trunk_match_jax(monkeypatch, resident):
    _three_train_steps(monkeypatch, resident, bf16=True)


@pytest.mark.parametrize(
    "ffn_impl,bf16", [("dense", False), ("fused", False), ("dense", True)],
    ids=["dense-float32", "fused_ffn-float32", "dense-bfloat16"],
)
def test_three_train_steps_conformer_match_jax(monkeypatch, ffn_impl, bf16):
    family = (JConformer, JConformerCfg, Conformer, ConformerConfig,
              dict(ffn_impl=ffn_impl, **SMALL_CONFORMER))
    if not bf16:
        _three_train_steps(monkeypatch, "force", family=family, conformer=True)
        return
    monkeypatch.setattr(torch, "sigmoid", lambda x: 1.0 / (1.0 + torch.exp(-x)))
    _three_train_steps(monkeypatch, "force", bf16=True, family=family, conformer=True)


def _three_train_steps(monkeypatch, resident, bf16=False,
                       family=(JTDNNF, JCfg, TDNNF, TdnnfConfig, SMALL), conformer=False,
                       batch_fn=None, sups=None, dens=None):
    """`batch_fn`, `sups` and `dens` replace the standard batch, the
    (JAX, port) supervision placement and the (JAX, port) denominator graph
    (default: ChainDataset, DeviceSupervision, the resident graph)."""
    JModel, JConfig, TModel, TConfig, small = family
    batch_fn = batch_fn or _batch
    j_sup, t_sup = sups or (
        lambda b: JSup.from_host(b.sup).with_kernel_tables(),
        lambda b: DeviceSupervision.from_host(b.sup, device="cpu").with_kernel_tables())
    j_den, t_den = dens or (
        lambda c: JResident.from_host(c.den_graph, pad_to=8, dtype=jnp.float32),
        lambda c: auto_den_graph(c.den_graph, pad_to=8, device="cpu"))
    monkeypatch.setenv("TORCHAIN_NUM_RESIDENT", resident)
    jc, _ = batch_fn(jdata, jgraphs, TConfig(num_pdfs=1, **small))
    P = jc.tree.num_pdfs
    jcfg = JConfig(num_pdfs=P, dtype=jnp.bfloat16 if bf16 else jnp.float32, **small)
    tcfg = TConfig(num_pdfs=P, dtype=torch.bfloat16 if bf16 else torch.float32, **small)
    m_rtol, p_atol, s_atol = (2e-2, 6e-3, 2e-3) if bf16 else (1e-4, 1e-5, 1e-5)
    if conformer and not bf16:
        p_atol = 3e-5  # 1.1e-5 seen, on an element whose later gradients are small
    jc, jbatch = batch_fn(jdata, jgraphs, jcfg)
    tc, tbatch = batch_fn(tdata, tgraphs, tcfg)
    np.testing.assert_array_equal(jbatch.feats, tbatch.feats)

    # JAX side: the bench's construction (bench.py _build), small widths
    feats = jnp.asarray(jbatch.feats)
    jstate = j_create(JModel(jcfg), feats,
                      optax.chain(optax.clip_by_global_norm(5.0), optax.adam(1e-3)),
                      rng=jax.random.PRNGKey(1))
    init_params = jax.tree.map(np.asarray, jstate.params)
    init_stats = jax.tree.map(np.asarray, jstate.batch_stats)
    jden = j_den(jc)
    jsup = j_sup(jbatch)
    jstep = j_make_step(JOpts(**OPTS), donate=False)
    if conformer and bf16:
        # round where the program says: by default XLA keeps float32 values
        # where it fuses two bfloat16 ops, which the eager port cannot mirror
        jstep = jstep.lower(jstate, feats, jden, jsup).compile(
            compiler_options={"xla_allow_excess_precision": False})

    # port, from the same parameters
    model = TModel(tcfg, tc.feat_dim, device="cpu")
    model.load_state_dict(params_from_jax(init_params, init_stats, tcfg))
    state = create_train_state(model, lr=1e-3)
    step = make_train_step(state, ChainLossOptions(**OPTS), max_grad_norm=5.0)
    tden = t_den(tc)
    tsup = t_sup(tbatch)
    tfeats = torch.as_tensor(tbatch.feats)

    grad1, losses = None, []
    for i in range(STEPS):
        jstate, jm = jstep(jstate, feats, jden, jsup)
        tm = step(tfeats, tden, tsup)
        if grad1 is None:
            grad1 = {k: p.grad.clone() for k, p in model.named_parameters()}
        losses.append(float(tm["loss"]))
        assert set(tm) == set(jm)
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=m_rtol, atol=1e-7,
                                       err_msg=f"step {i + 1} {k}")
    assert state.step == STEPS
    # the replayed batch is being learned
    assert losses[-1] < losses[0]

    named = dict(model.named_parameters())
    close = total = 0
    for k, v in _flatten(jax.tree.map(np.asarray, jstate.params)).items():
        assert named[k].dtype == torch.float32 and v.dtype == np.float32
        keep = grad1[k].abs().numpy() >= 1e-6
        got = named[k].detach().numpy()[keep]
        np.testing.assert_allclose(got, v[keep], atol=p_atol, err_msg=k)
        close += int((np.abs(got - v[keep]) <= 1e-4).sum())
        total += got.size
    # bfloat16: 79% of the elements were within 1e-4 when this was written
    assert close >= (0.6 if bf16 else 1.0) * total
    buffers = dict(model.named_buffers())
    for k, v in _flatten(jax.tree.map(np.asarray, jstate.batch_stats)).items():
        atol = s_atol
        if conformer and k.endswith("BatchNorm_0.mean") and k.startswith("block"):
            # the depthwise bias sits in front of this batchnorm: its true
            # gradient is 0, Adam turns the rounding noise into steps of 1e-3
            # either way, and the batch mean follows the bias (2.8e-5 seen)
            atol = max(s_atol, 1e-4)
        np.testing.assert_allclose(buffers[k].numpy(), v, atol=atol, err_msg=k)


def test_clip_by_global_norm_matches_optax():
    """The port's clip is optax's: scale by max_norm / ||g|| (no epsilon)."""
    rng = np.random.default_rng(0)
    gs = [rng.normal(size=s).astype(np.float32) for s in ((3, 4), (5,))]
    from torchain_tpu_torch.train import clip_by_global_norm_

    for max_norm in (0.5, 100.0):
        tg = [torch.tensor(g) for g in gs]
        norm = clip_by_global_norm_(tg, max_norm)
        ref, _ = optax.clip_by_global_norm(max_norm).update([jnp.asarray(g) for g in gs], None)
        np.testing.assert_allclose(float(norm), float(optax.global_norm(gs)), rtol=1e-6)
        for a, b in zip(tg, ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
