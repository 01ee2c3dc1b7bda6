"""The port's Trainer (torchain_tpu_torch/train/trainer.py) against the JAX
package's Trainer on the CPU, and its own checkpoint, resume and dropout
contracts.

`Trainer.fit` trains a 3-layer TDNN-F (hidden 32, bottleneck 8) on a
synthetic corpus for 6 steps (2 batches of 3 chunks an epoch, 3 epochs)
with both Trainers, from the same parameters (convert.params_from_jax),
under five configurations: Adam with clip, exponential LR decay,
max-change and the semi-orthogonal constraint every 2 steps; SGD with
momentum; gradient accumulation over 2 micro-batches; backstitch 0.3; and
the plain TDNN.  The JAX side runs its denominator and numerator as its
dispatchers choose on the CPU; the port's wrappers run their plain
versions.

Tolerances, float32: rtol 1e-4 on every per-step metric (atol 1e-7); after
the 6 steps atol 1e-5 on the parameters and the batchnorm statistics.
Parameter elements whose step-1 gradient is below 1e-6 in magnitude are
left out, as tests/test_torch_train.py does: there Adam's g / (|g| + eps)
turns float32 rounding of g into a different step.  `evaluate` is held to
rtol 1e-4.

Resume and dropout are the port's own contracts, held bit for bit: 3
steps, a checkpoint, a fresh Trainer and 3 more give the parameters,
statistics and metrics of 6 uninterrupted steps, with and without dropout
at rate 0.2.  A rate-0 dropout schedule takes the unfused bypass add, so it
meets no dropout to rounding (rtol 1e-6), not to the bit.
"""

import dataclasses

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
from torchain_tpu.models import TDNN as JTDNN
from torchain_tpu.models import TDNNF as JTDNNF
from torchain_tpu.models import TdnnConfig as JTdnnCfg
from torchain_tpu.models import TdnnfConfig as JTdnnfCfg
from torchain_tpu.ops import ChainLossOptions as JOpts
from torchain_tpu.ops import auto_den_graph as j_auto_den
from torchain_tpu.train import Trainer as JTrainer
from torchain_tpu.train import TrainerConfig as JTrainerConfig
from torchain_tpu.train.trainer import make_optimizer as j_make_optimizer
from torchain_tpu.train.trainer import max_change as j_max_change
from torchain_tpu.train.trainer import parse_dropout_schedule as j_parse
from torchain_tpu_torch.convert import _flatten, params_from_jax
from torchain_tpu_torch.models import TDNN, TDNNF, TdnnConfig, TdnnfConfig
from torchain_tpu_torch.ops import ChainLossOptions, auto_den_graph
from torchain_tpu_torch.train import (
    Trainer,
    TrainerConfig,
    make_optimizer,
    max_change,
    parse_dropout_schedule,
)
from torchain_tpu_torch.train.trainer import lr_schedule

CORPUS = dict(num_utts=6, num_phones=4, feat_dim=8, utt_frames_out=(7, 9), seed=2)
OPTS = dict(l2_regularize=5e-4, leaky_hmm_coefficient=0.1, xent_regularize=0.1)
TDNNF_SMALL = dict(hidden_dim=32, bottleneck_dim=8, prefinal_dim=16, num_layers=3)
TDNN_SMALL = dict(hidden_dim=32, prefinal_dim=16, layers=((3, 1, 1), (3, 1, 3), (3, 3, 1)))
B, T_OUT, EPOCHS = 3, 6, 3
#: per-step metrics the two Trainers both log (wall_s, frames_per_s are clocks)
METRICS = ("objf", "l2_term", "oor_term", "xent_objf", "weight", "num_failed", "loss",
           "grad_norm", "step", "epoch")

CASES = {
    "adam_decay_maxchange_semiortho": dict(
        lr=3e-3, lr_final=3e-4, lr_decay_steps=6, grad_clip=1.0,
        max_change_per_component=0.05, max_param_change=0.1, semi_ortho_every=2),
    "sgd_momentum": dict(optimizer="sgd", lr=2e-2, momentum=0.9, semi_ortho_every=0),
    "grad_accum_2": dict(grad_accum_steps=2, semi_ortho_every=0),
    "backstitch_0.3": dict(optimizer="sgd", lr=2e-2, momentum=0.0, backstitch_scale=0.3,
                           semi_ortho_every=0),
    "tdnn": dict(semi_ortho_every=0),
}


def _dataset(pkg_data, pkg_graphs, cfg, seed=0):
    c = pkg_data.synthetic_dataset(**CORPUS)
    left, right = cfg.context
    ds = pkg_data.ChainDataset(
        c.utts, c.tree, c.norm_fst, chunk_frames_out=T_OUT, left_context=left,
        right_context=right, seed=seed,
        sup_opts=pkg_graphs.SupervisionOptions(left_tolerance=2, right_tolerance=2),
    )
    return c, ds


def _families(case):
    if case == "tdnn":
        return JTDNN, JTdnnCfg, TDNN, TdnnConfig, TDNN_SMALL
    return JTDNNF, JTdnnfCfg, TDNNF, TdnnfConfig, TDNNF_SMALL


def _jax_trainer(case, P, feat_dim, cfg_kw, tmp=None):
    JModel, JConfig, _, _, small = _families(case)
    jcfg = JConfig(num_pdfs=P, **small)
    jc, jds = _dataset(jdata, jgraphs, jcfg)
    left, right = jcfg.context
    tcfg = JTrainerConfig(batch_size=B, num_epochs=EPOCHS, log_every=1, loss=JOpts(**OPTS),
                          checkpoint_dir=tmp, **cfg_kw)
    example = np.zeros((2, T_OUT * 3 + left + right, feat_dim), np.float32)
    return JTrainer(JModel(jcfg), j_auto_den(jc.den_graph), tcfg, example), jds


def _port_trainer(case, P, feat_dim, cfg_kw, params=None, stats=None, **extra):
    _, _, TModel, TConfig, small = _families(case)
    tcfg = TConfig(num_pdfs=P, **small)
    tc, tds = _dataset(tdata, tgraphs, tcfg)
    model = TModel(tcfg, feat_dim, device="cpu", generator=torch.Generator().manual_seed(0))
    if params is not None:
        model.load_state_dict(params_from_jax(params, stats, tcfg))
    cfg = TrainerConfig(batch_size=B, num_epochs=EPOCHS, log_every=1,
                        loss=ChainLossOptions(**OPTS), device="cpu", **{**cfg_kw, **extra})
    return Trainer(model, auto_den_graph(tc.den_graph, device="cpu"), cfg, tree=tc.tree), tds


def _capture_first_grads(trainer):
    """Wrap the trainer's step functions so that the gradients of the first
    step are kept (the mask of elements Adam may move apart)."""
    grads = {}

    def wrap(fn):
        def run(*a, **k):
            out = fn(*a, **k)
            if not grads:
                grads.update({n: p.grad.clone() for n, p in trainer.model.named_parameters()})
            return out
        return run

    trainer.train_step = wrap(trainer.train_step)
    if trainer.backstitch_step is not None:
        trainer.backstitch_step = wrap(trainer.backstitch_step)
    return grads


@pytest.mark.parametrize("case", sorted(CASES))
def test_fit_matches_the_jax_trainer(case):
    c = jdata.synthetic_dataset(**CORPUS)
    P, F = c.tree.num_pdfs, c.feat_dim
    jtr, jds = _jax_trainer(case, P, F, CASES[case])
    params = jax.tree.map(np.asarray, jtr.state.params)
    stats = jax.tree.map(np.asarray, jtr.state.batch_stats)
    ttr, tds = _port_trainer(case, P, F, CASES[case], params, stats)
    grad1 = _capture_first_grads(ttr)
    jtr.fit(jds, log_fn=lambda s: None)
    ttr.fit(tds, log_fn=lambda s: None)

    assert int(jtr.state.step) == ttr.state.step == 2 * EPOCHS
    assert len(ttr.metrics_log) == len(jtr.metrics_log) == 2 * EPOCHS
    for i, (tm, jm) in enumerate(zip(ttr.metrics_log, jtr.metrics_log)):
        assert set(tm) == set(jm)
        for k in METRICS:
            np.testing.assert_allclose(tm[k], jm[k], rtol=1e-4, atol=1e-7,
                                       err_msg=f"step {i + 1} {k}")
    named = dict(ttr.model.named_parameters())
    for k, v in _flatten(jax.tree.map(np.asarray, jtr.state.params)).items():
        keep = grad1[k].abs().numpy() >= 1e-6
        np.testing.assert_allclose(named[k].detach().numpy()[keep], v[keep], atol=1e-5,
                                   err_msg=k)
    buffers = dict(ttr.model.named_buffers())
    for k, v in _flatten(jax.tree.map(np.asarray, jtr.state.batch_stats)).items():
        np.testing.assert_allclose(buffers[k].numpy(), v, atol=1e-5, err_msg=k)

    if case == "adam_decay_maxchange_semiortho":
        # the validation pass on the trained models
        jres, tres = jtr.evaluate(jds), ttr.evaluate(tds)
        assert tres.steps == jres.steps == 2
        for k in ("tot_objf", "tot_l2", "tot_xent", "tot_weight"):
            np.testing.assert_allclose(getattr(tres, k), getattr(jres, k), rtol=1e-4, err_msg=k)


def _state(trainer):
    return ({k: v.detach().clone() for k, v in trainer.model.state_dict().items()},
            [{k: v for k, v in m.items() if k not in ("wall_s", "frames_per_s")}
             for m in trainer.metrics_log])


@pytest.mark.parametrize("schedule", ["", "0.2"], ids=["no_dropout", "dropout_0.2"])
def test_resume_is_bit_exact(tmp_path, schedule):
    c = tdata.synthetic_dataset(**CORPUS)
    P, F = c.tree.num_pdfs, c.feat_dim
    kw = dict(lr_final=1e-4, lr_decay_steps=6, max_change_per_component=0.5,
              semi_ortho_every=2, dropout_schedule=schedule)
    whole, ds = _port_trainer("tdnnf", P, F, kw)
    whole.fit(ds, log_fn=lambda s: None)
    ref_sd, ref_log = _state(whole)

    d = str(tmp_path / "ck")
    first, ds = _port_trainer("tdnnf", P, F, kw, checkpoint_dir=d)
    first.fit(ds, log_fn=lambda s: None, max_steps=3)
    assert first.all_steps() == [3]
    second, ds = _port_trainer("tdnnf", P, F, kw, checkpoint_dir=d)
    assert second.restore_checkpoint()
    assert (second.state.step, second.start_epoch, second.skip_batches) == (3, 1, 1)
    second.fit(ds, log_fn=lambda s: None)
    sd, log = _state(second)
    assert second.state.step == 6
    for k, v in ref_sd.items():
        assert torch.equal(sd[k], v), k
    assert log == ref_log[3:]
    # the masks differ from step to step, and the model saw them
    if schedule:
        quiet, ds = _port_trainer("tdnnf", P, F, {**kw, "dropout_schedule": ""})
        quiet.fit(ds, log_fn=lambda s: None)
        assert not torch.equal(quiet.model.tdnnf0.affine.kernel, whole.model.tdnnf0.affine.kernel)


def test_dropout_at_rate_zero_meets_no_dropout():
    c = tdata.synthetic_dataset(**CORPUS)
    P, F = c.tree.num_pdfs, c.feat_dim
    runs = []
    for schedule in ("", "0,0"):
        tr, ds = _port_trainer("tdnnf", P, F, dict(dropout_schedule=schedule))
        tr.fit(ds, log_fn=lambda s: None)
        runs.append(_state(tr))
    (sd0, log0), (sd1, log1) = runs
    for k, v in sd0.items():
        np.testing.assert_allclose(sd1[k].numpy(), v.numpy(), rtol=1e-6, atol=1e-7, err_msg=k)
    for a, b in zip(log0, log1):
        for k in METRICS:
            np.testing.assert_allclose(b[k], a[k], rtol=1e-6, atol=1e-7, err_msg=k)


def test_combine_averages_the_last_checkpoints(tmp_path):
    c = tdata.synthetic_dataset(**CORPUS)
    P, F = c.tree.num_pdfs, c.feat_dim
    tr, ds = _port_trainer("tdnnf", P, F, {}, checkpoint_dir=str(tmp_path), checkpoint_every=1)
    tr.fit(ds, log_fn=lambda s: None)
    assert tr.all_steps() == [4, 5, 6]  # the newest three are kept
    sds = [torch.load(tmp_path / str(s) / "state.pt", weights_only=True)["model"]
           for s in (4, 5, 6)]
    stats = {k: v.clone() for k, v in tr.model.named_buffers()}
    assert tr.combine(3) == 3
    for k, p in tr.model.named_parameters():
        want = (sds[0][k] + sds[1][k] + sds[2][k]) / 3
        np.testing.assert_allclose(p.detach().numpy(), want.numpy(), rtol=1e-6, atol=1e-7)
    for k, b in tr.model.named_buffers():
        assert torch.equal(b, stats[k])


def test_resume_refuses_a_changed_den_graph(tmp_path):
    c = tdata.synthetic_dataset(**CORPUS)
    P, F = c.tree.num_pdfs, c.feat_dim
    d = str(tmp_path / "ck")
    tr, ds = _port_trainer("tdnnf", P, F, {}, checkpoint_dir=d)
    tr.fit(ds, log_fn=lambda s: None, max_steps=1)
    other = tdata.synthetic_dataset(**{**CORPUS, "seed": 99})
    tr2 = Trainer(TDNNF(TdnnfConfig(num_pdfs=P, **TDNNF_SMALL), F, device="cpu"),
                  auto_den_graph(other.den_graph, device="cpu"),
                  TrainerConfig(checkpoint_dir=d, device="cpu"), tree=other.tree)
    with pytest.raises(ValueError, match="refusing to resume"):
        tr2.restore_checkpoint()
    tr3, _ = _port_trainer("tdnnf", P, F, {}, checkpoint_dir=d)
    assert tr3.restore_checkpoint() and tr3.state.step == 1


def test_optimizers_not_ported_are_refused():
    """Every optimizer of the JAX package is taken (adam, adam-lowmem, sgd,
    ngsgd); a name the JAX package does not have either is refused."""
    for name in ("adam", "adam-lowmem", "sgd", "ngsgd"):
        make_optimizer(TrainerConfig(optimizer=name, device="cpu"),
                       [torch.nn.Parameter(torch.zeros(2))])
    for name in ("lamb", "adafactor"):
        with pytest.raises(ValueError, match="not ported"):
            make_optimizer(TrainerConfig(optimizer=name, device="cpu"),
                           [torch.nn.Parameter(torch.zeros(2))])


def test_backstitch_and_dropout_are_exclusive():
    c = tdata.synthetic_dataset(**CORPUS)
    with pytest.raises(ValueError, match="mutually"):
        _port_trainer("tdnnf", c.tree.num_pdfs, c.feat_dim,
                      dict(backstitch_scale=0.3, dropout_schedule="0,0.5"))


# -- the optimizer's pieces against optax -------------------------------------


@pytest.mark.parametrize("pc,gc", [(1.0, 0.0), (0.0, 2.0), (0.75, 2.0), (100.0, 100.0)])
def test_max_change_matches_jax(pc, gc):
    rng = np.random.default_rng(0)
    ups = [rng.normal(size=s).astype(np.float32) * 3 for s in ((4, 4), (6,), (2, 3, 5))]
    tx = j_max_change(pc, gc)
    ref, _ = tx.update(ups, tx.init(ups))
    got = max_change(pc, gc)([torch.tensor(u) for u in ups])
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)


SCHEDULES = ["", "0.3", "0,0.5", "0,0@0.20,0.5@0.50,0", "0.1@0.3,0.4@0.6", "0.2,0.1@0.5,0"]


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_parse_dropout_schedule_matches_jax(schedule):
    grid = np.linspace(-0.1, 1.1, 49)
    ours, ref = parse_dropout_schedule(schedule), j_parse(schedule)
    np.testing.assert_array_equal([ours(p) for p in grid], [ref(p) for p in grid])


def test_parse_dropout_schedule_refuses_alike():
    for bad in ("0,0.5,0", "0.1@0.6,0.2@0.3"):
        with pytest.raises(ValueError):
            j_parse(bad)
        with pytest.raises(ValueError):
            parse_dropout_schedule(bad)


@pytest.mark.parametrize("optimizer", ["adam", "sgd"])
def test_optimizer_chain_matches_optax(optimizer):
    """Six updates of the whole chain (clip, exponential LR decay, Adam or
    SGD with momentum, max-change, accumulation over 2) on fixed gradients,
    against make_optimizer of the JAX package."""
    kw = dict(optimizer=optimizer, lr=0.05, lr_final=0.005, lr_decay_steps=3, grad_clip=2.0,
              max_change_per_component=0.04, max_param_change=0.06, grad_accum_steps=2)
    jcfg = JTrainerConfig(**kw)
    rng = np.random.default_rng(1)
    p0 = [rng.normal(size=s).astype(np.float32) for s in ((5, 3), (7,))]
    gs = [[rng.normal(size=p.shape).astype(np.float32) * 3 for p in p0] for _ in range(6)]
    tx = j_make_optimizer(jcfg)
    jp, st = [jnp.asarray(p) for p in p0], None
    st = tx.init(jp)
    params = [torch.nn.Parameter(torch.tensor(p)) for p in p0]
    opt = make_optimizer(TrainerConfig(device="cpu", **kw), params)
    for g in gs:
        u, st = tx.update([jnp.asarray(x) for x in g], st, jp)
        jp = optax.apply_updates(jp, u)
        for p, x in zip(params, g):
            p.grad = torch.tensor(x)
        opt.step()
        for a, b in zip(params, jp):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)
    assert opt.count == 3


def test_lr_schedule_matches_optax_exponential_decay():
    cfg = TrainerConfig(lr=1e-3, lr_final=1e-4, lr_decay_steps=10, device="cpu")
    ref = optax.exponential_decay(init_value=1e-3, transition_steps=10, decay_rate=0.1,
                                  end_value=1e-4)
    ours = lr_schedule(cfg)
    for count in range(15):
        # numpy's and XLA's float32 pow differ by an ulp or two
        np.testing.assert_allclose(ours(count), float(ref(count)), rtol=1e-6)
    assert lr_schedule(dataclasses.replace(cfg, lr_final=0.0))(5) == 1e-3
