"""The slice as a whole: three chain training steps of a small TDNN-F on
the same batch, with the JAX package's make_train_step (resident
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
atol 2e-3 (5.5e-4 seen)."""

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
from torchain_tpu.models import TDNNF as JTDNNF
from torchain_tpu.models import TdnnfConfig as JCfg
from torchain_tpu.ops import ChainLossOptions as JOpts
from torchain_tpu.ops.den_resident import DeviceResidentDenGraph as JResident
from torchain_tpu.ops.device_graphs import DeviceSupervision as JSup
from torchain_tpu.train import create_train_state as j_create
from torchain_tpu.train import make_train_step as j_make_step
from torchain_tpu_torch.convert import _flatten, params_from_jax
from torchain_tpu_torch.models import TDNNF, TdnnfConfig
from torchain_tpu_torch.ops import ChainLossOptions, DeviceSupervision, auto_den_graph
from torchain_tpu_torch.train import create_train_state, make_train_step

CORPUS = dict(num_utts=6, num_phones=4, feat_dim=8, utt_frames_out=(7, 9), seed=2)
SMALL = dict(hidden_dim=64, bottleneck_dim=16, prefinal_dim=32, num_layers=3)
OPTS = dict(l2_regularize=5e-4, leaky_hmm_coefficient=0.1, xent_regularize=0.1)
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


def test_three_train_steps_match_jax(monkeypatch):
    _three_train_steps(monkeypatch, "0")


def test_three_train_steps_match_jax_resident_numerator(monkeypatch):
    _three_train_steps(monkeypatch, "force")


@pytest.mark.parametrize("resident", ["0", "force"])
def test_three_train_steps_bf16_trunk_match_jax(monkeypatch, resident):
    _three_train_steps(monkeypatch, resident, bf16=True)


def _three_train_steps(monkeypatch, resident, bf16=False):
    monkeypatch.setenv("TORCHAIN_NUM_RESIDENT", resident)
    jc, _ = _batch(jdata, jgraphs, TdnnfConfig(num_pdfs=1, **SMALL))
    P = jc.tree.num_pdfs
    jcfg = JCfg(num_pdfs=P, dtype=jnp.bfloat16 if bf16 else jnp.float32, **SMALL)
    tcfg = TdnnfConfig(num_pdfs=P, dtype=torch.bfloat16 if bf16 else torch.float32, **SMALL)
    m_rtol, p_atol, s_atol = (2e-2, 6e-3, 2e-3) if bf16 else (1e-4, 1e-5, 1e-5)
    jc, jbatch = _batch(jdata, jgraphs, jcfg)
    tc, tbatch = _batch(tdata, tgraphs, tcfg)
    np.testing.assert_array_equal(jbatch.feats, tbatch.feats)

    # JAX side: the bench's construction (bench.py _build), small widths
    feats = jnp.asarray(jbatch.feats)
    jstate = j_create(JTDNNF(jcfg), feats,
                      optax.chain(optax.clip_by_global_norm(5.0), optax.adam(1e-3)),
                      rng=jax.random.PRNGKey(1))
    init_params = jax.tree.map(np.asarray, jstate.params)
    init_stats = jax.tree.map(np.asarray, jstate.batch_stats)
    jden = JResident.from_host(jc.den_graph, pad_to=8, dtype=jnp.float32)
    jsup = JSup.from_host(jbatch.sup).with_kernel_tables()
    jstep = j_make_step(JOpts(**OPTS), donate=False)

    # port, from the same parameters
    model = TDNNF(tcfg, tc.feat_dim, device="cpu")
    model.load_state_dict(params_from_jax(init_params, init_stats, tcfg))
    state = create_train_state(model, lr=1e-3)
    step = make_train_step(state, ChainLossOptions(**OPTS), max_grad_norm=5.0)
    tden = auto_den_graph(tc.den_graph, pad_to=8, device="cpu")
    tsup = DeviceSupervision.from_host(tbatch.sup, device="cpu").with_kernel_tables()
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
        np.testing.assert_allclose(buffers[k].numpy(), v, atol=s_atol, err_msg=k)


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
