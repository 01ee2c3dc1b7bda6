"""The Trainer's optimizer chain (torchain_tpu_torch/train/chain_tx.py
`ChainOptimizer`: the JAX package's optax chain with its whole state on the
device and no host read in a step, the arithmetic of the captured steps)
and what `TrainerConfig(capture=True)` needs of the data, on the CPU:

  (a) the chain against the JAX package's `make_optimizer` (optax) over 6
      updates of a small TDNN-F's parameters (carried across by
      `convert.params_from_jax`) on seeded gradients: adam, adam-lowmem,
      and sgd with momentum, each with exponential LR decay, clip and
      max-change, under accumulation 1 and 2 (ngsgd in
      tests/test_torch_ngsgd.py).  Tolerance rel 1e-5 (atol 1e-6 for
      entries near 0), float32;
  (b) the backstitch step on the chain's planned calls against the JAX
      `make_backstitch_step` over 2 steps under accumulation 2 (the first
      step's first pass only accumulates): metrics rtol 1e-4, parameters
      atol 1e-5 where the step-1 gradient is at least 1e-6 and the
      batchnorm statistics atol 1e-5, as tests/test_torch_train.py holds
      the train step;
  (c) the checkpoint format is torch's optimizer's (torch.optim.Adam and
      SGD, LowmemAdam, NGSGD): a state written by that optimizer after 3
      of its own steps restores into the chain tensor for tensor, the
      chain's state restores into that optimizer alike, and a chain
      restored from its own checkpoint (mid-accumulation, through
      torch.save) takes the writer's next updates bit for bit;
  (d) every dataset of the port fixes one live-arc list width
      (`estimate_live_arcs`: ChainDataset, MaterializedBatches on the host
      and placed, CegsDataset): no batch's list is longer, one is as long,
      and every batch placed at it has one shape; a dataset that cannot
      fix one shape makes capture raise ValueError;
  (e) a dropout rate given as a float32 device scalar (a captured step's)
      gives the float rate's masks and outputs bit for bit;
  (f) `TrainerConfig(capture=True)` raises ValueError on the CPU, and the
      chain is captured only with `update` given.

The captured graphs themselves run on the card: tests/test_torch_cuda.py
and chip_smoke.py's `captured` phase."""

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
from tests.test_torch_trainer import CORPUS, OPTS, TDNNF_SMALL
from torchain_tpu.models import TDNNF as JTDNNF
from torchain_tpu.models import TdnnfConfig as JCfg
from torchain_tpu.ops import ChainLossOptions as JOpts
from torchain_tpu.ops.den_resident import DeviceResidentDenGraph as JResident
from torchain_tpu.ops.device_graphs import DeviceSupervision as JSup
from torchain_tpu.train.state import ChainTrainState as JState
from torchain_tpu.train.step import make_backstitch_step as j_backstitch
from torchain_tpu.train.trainer import TrainerConfig as JTrainerConfig
from torchain_tpu.train.trainer import make_optimizer as j_make_optimizer
from torchain_tpu_torch.convert import _flatten, params_from_jax
from torchain_tpu_torch.data import CegsDataset, MaterializedBatches, dataset_to_cegs
from torchain_tpu_torch.data.materialize import PlacedBatch
from torchain_tpu_torch.models import TDNNF, TdnnfConfig, continuous_dropout
from torchain_tpu_torch.ops import ChainLossOptions, DeviceSupervision, auto_den_graph
from torchain_tpu_torch.train import (
    NGSGD,
    ChainOptimizer,
    ChainTrainState,
    LowmemAdam,
    Trainer,
    TrainerConfig,
    make_backstitch_step,
    make_train_step,
)

SMALL = dict(hidden_dim=16, bottleneck_dim=4, prefinal_dim=8, num_layers=2)
#: the chain of (a)-(c): LR decay, clip, max-change
CHAIN = dict(lr=0.05, lr_final=0.005, lr_decay_steps=3, grad_clip=2.0,
             max_change_per_component=0.04, max_param_change=0.06)
UPDATES = 6


@pytest.fixture(scope="module")
def jax_params():
    """A small TDNN-F's parameters for the synthetic corpus's pdfs,
    initialised by the JAX package (params, batch_stats, config)."""
    c = jdata.synthetic_dataset(**CORPUS)
    cfg = JCfg(num_pdfs=c.tree.num_pdfs, **SMALL)
    feats = jnp.zeros((2, 20, c.feat_dim), jnp.float32)
    model = JTDNNF(cfg)
    v = jax.jit(lambda x: model.init(jax.random.PRNGKey(3), x, train=False))(feats)
    return jax.tree.map(np.asarray, v["params"]), jax.tree.map(np.asarray, v["batch_stats"]), cfg


def _port_model(jax_params):
    params, stats, jcfg = jax_params
    tcfg = TdnnfConfig(num_pdfs=jcfg.num_pdfs, **SMALL)
    model = TDNNF(tcfg, CORPUS["feat_dim"], device="cpu")
    model.load_state_dict(params_from_jax(params, stats, tcfg))
    return model


def _gradients(names_shapes, n, seed=1):
    rng = np.random.default_rng(seed)
    return [{k: (rng.normal(size=s) * 3).astype(np.float32) for k, s in names_shapes}
            for _ in range(n)]


def _set_grads(model, g):
    for k, p in model.named_parameters():
        p.grad = torch.tensor(g[k])


CASES = [(opt, k) for opt in ("adam", "adam-lowmem", "sgd") for k in (1, 2)]


@pytest.mark.parametrize("optimizer,accum", CASES,
                         ids=[f"{o}-accum{k}" for o, k in CASES])
def test_sync_free_chain_matches_optax(jax_params, optimizer, accum):
    """(a)."""
    params, _, _ = jax_params
    kw = dict(optimizer=optimizer, momentum=0.9, grad_accum_steps=accum, **CHAIN)
    tx = j_make_optimizer(JTrainerConfig(**kw))
    jp = jax.tree.map(jnp.asarray, params)
    st = tx.init(jp)
    update = jax.jit(tx.update)
    model = _port_model(jax_params)
    chain = ChainOptimizer(model.parameters(), TrainerConfig(device="cpu", **kw))
    named = dict(model.named_parameters())
    flat = _flatten(params)
    for g in _gradients([(k, v.shape) for k, v in flat.items()], UPDATES * accum):
        jg = jax.tree.map(jnp.asarray, _unflatten_like(params, g))
        u, st = update(jg, st, jp)
        jp = optax.apply_updates(jp, u)
        _set_grads(model, g)
        chain.step()
        for k, v in _flatten(jax.tree.map(np.asarray, jp)).items():
            np.testing.assert_allclose(named[k].detach().numpy(), v, rtol=1e-5, atol=1e-6,
                                       err_msg=k)
    assert chain.count == UPDATES and int(chain.count_t) == UPDATES
    assert chain.mini_step == int(chain.mini_t) == 0


def _unflatten_like(tree, flat, prefix=""):
    if isinstance(tree, dict):
        return {k: _unflatten_like(v, flat, f"{prefix}{k}.") for k, v in tree.items()}
    return flat[prefix[:-1]]


def _batch(pkg_data, pkg_graphs):
    c = pkg_data.synthetic_dataset(**CORPUS)
    ds = pkg_data.ChainDataset(
        c.utts, c.tree, c.norm_fst, chunk_frames_out=6, left_context=JCfg(**SMALL).context[0],
        right_context=JCfg(**SMALL).context[1],
        sup_opts=pkg_graphs.SupervisionOptions(left_tolerance=2, right_tolerance=2))
    return c, next(ds.batches(3, shuffle=False))


def test_sync_free_backstitch_matches_jax(jax_params):
    """(b)."""
    kw = dict(optimizer="adam", grad_accum_steps=2, lr=3e-3, lr_final=3e-4, lr_decay_steps=2,
              grad_clip=1.0, max_change_per_component=0.05, max_param_change=0.1)
    jc, jbatch = _batch(jdata, jgraphs)
    tc, tbatch = _batch(tdata, tgraphs)
    params, stats, jcfg = jax_params
    feats = jnp.asarray(jbatch.feats)
    tx = j_make_optimizer(JTrainerConfig(**kw))
    jstate = JState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
                    opt_state=tx.init(params), apply_fn=JTDNNF(jcfg).apply, tx=tx)
    jden = JResident.from_host(jc.den_graph, pad_to=8, dtype=jnp.float32)
    jsup = JSup.from_host(jbatch.sup).with_kernel_tables()
    jstep = j_backstitch(JOpts(**OPTS), 0.3, donate=False)

    model = _port_model(jax_params)
    chain = ChainOptimizer(model.parameters(), TrainerConfig(device="cpu", **kw))
    state = ChainTrainState(model=model, optimizer=chain)
    tden = auto_den_graph(tc.den_graph, pad_to=8, device="cpu")
    tsup = DeviceSupervision.from_host(tbatch.sup, device="cpu").with_kernel_tables()
    tfeats = torch.as_tensor(tbatch.feats)
    grad1 = None
    for i in range(2):
        plan = chain.plan(2)
        assert plan == ("accumulate", "update")
        step = make_backstitch_step(state, ChainLossOptions(**OPTS), 0.3,
                                    update=lambda j, s, plan=plan: chain.apply(plan[j], s))
        jstate, jm = jstep(jstate, feats, jden, jsup)
        tm = step(tfeats, tden, tsup)
        chain.advance(plan)
        if grad1 is None:
            grad1 = {k: p.grad.clone() for k, p in model.named_parameters()}
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4, atol=1e-7,
                                       err_msg=f"step {i + 1} {k}")
    assert chain.count == 2 and state.step == 2
    named = dict(model.named_parameters())
    for k, v in _flatten(jax.tree.map(np.asarray, jstate.params)).items():
        keep = grad1[k].abs().numpy() >= 1e-6
        np.testing.assert_allclose(named[k].detach().numpy()[keep], v[keep], atol=1e-5,
                                   err_msg=k)
    buffers = dict(model.named_buffers())
    for k, v in _flatten(jax.tree.map(np.asarray, jstate.batch_stats)).items():
        np.testing.assert_allclose(buffers[k].numpy(), v, atol=1e-5, err_msg=k)


def _chain(jax_params, optimizer, accum):
    model = _port_model(jax_params)
    kw = dict(optimizer=optimizer, momentum=0.9, grad_accum_steps=accum, **CHAIN)
    return model, ChainOptimizer(model.parameters(), TrainerConfig(device="cpu", **kw))


def _values(model):
    return {k: p.detach().numpy().copy() for k, p in model.named_parameters()}


def _torch_optimizer(optimizer, params):
    """The torch optimizer whose `state_dict` is the chain's format."""
    if optimizer == "adam":
        return torch.optim.Adam(params, lr=CHAIN["lr"], betas=(0.9, 0.999), eps=1e-8)
    if optimizer == "adam-lowmem":
        return LowmemAdam(params, lr=CHAIN["lr"])
    cls = NGSGD if optimizer == "ngsgd" else torch.optim.SGD
    return cls(params, lr=CHAIN["lr"], momentum=0.9)


def _same_state(a: dict, b: dict) -> None:
    """Two torch optimizers' per-parameter states, tensor for tensor."""
    assert a.keys() == b.keys()
    for i in a:
        assert a[i].keys() == b[i].keys(), i
        for k in a[i]:
            assert torch.equal(torch.as_tensor(a[i][k]), torch.as_tensor(b[i][k])), (i, k)


@pytest.mark.parametrize("optimizer", ["adam", "adam-lowmem", "sgd", "ngsgd"])
def test_checkpoints_restore_across_the_two_chains(jax_params, optimizer):
    """(c): the two sides are torch's optimizer (the format's writer) and
    the chain."""
    import io

    names = [(k, p.shape) for k, p in _port_model(jax_params).named_parameters()]
    gs = _gradients(names, 6, seed=4)
    # torch's optimizer -> the chain: the state it made in 3 steps
    model = _port_model(jax_params)
    opt = _torch_optimizer(optimizer, list(model.parameters()))
    for g in gs[:3]:
        _set_grads(model, g)
        opt.step()
    written = opt.state_dict()
    _, chain = _chain(jax_params, optimizer, 1)
    chain.load_state_dict(dict(inner=written, count=3, mini_step=0, acc=None))
    assert int(chain.count_t) == chain.count == 3
    _same_state(chain.state_dict()["inner"]["state"], written["state"])
    # the chain -> torch's optimizer
    fresh = _torch_optimizer(optimizer, list(_port_model(jax_params).parameters()))
    fresh.load_state_dict(chain.state_dict()["inner"])
    _same_state(fresh.state_dict()["state"], written["state"])
    # the chain -> the chain, mid-accumulation: bit for bit after
    m_w, w = _chain(jax_params, optimizer, 2)
    for g in gs[:3]:
        _set_grads(m_w, g)
        w.step()
    buf = io.BytesIO()
    torch.save({"model": m_w.state_dict(), "optimizer": w.state_dict()}, buf)
    buf.seek(0)
    saved = torch.load(buf, weights_only=True)
    m_r, r = _chain(jax_params, optimizer, 2)
    m_r.load_state_dict(saved["model"])
    r.load_state_dict(saved["optimizer"])
    assert (r.count, r.mini_step) == (w.count, w.mini_step) == (1, 1)
    for g in gs[3:]:
        for model, chain in ((m_w, w), (m_r, r)):
            _set_grads(model, g)
            chain.step()
        for k, v in _values(m_w).items():
            np.testing.assert_array_equal(_values(m_r)[k], v, err_msg=k)


def _live_widths(batches):
    """Each placed batch's live-arc list width."""
    return [DeviceSupervision.from_host(b.sup, device="cpu").with_kernel_tables().arcs_k.shape[1]
            if not isinstance(b, PlacedBatch) else b.sup.arcs_k.shape[1] for b in batches]


def _small_dataset():
    c = tdata.synthetic_dataset(**CORPUS)
    left, right = TdnnfConfig(num_pdfs=1, **TDNNF_SMALL).context
    return tdata.ChainDataset(c.utts, c.tree, c.norm_fst, chunk_frames_out=6, left_context=left,
                              right_context=right, sup_opts=tgraphs.SupervisionOptions())


@pytest.mark.parametrize("source", ["chain", "materialized_host", "materialized_placed", "cegs"])
def test_datasets_fix_one_live_arc_width(source, tmp_path):
    """(d): the width is the longest list of any sequence, and every batch
    placed at it takes one shape."""
    ds = _small_dataset()
    if source.startswith("materialized"):
        ds = MaterializedBatches(ds, 3, device="cpu" if source.endswith("placed") else False)
    elif source == "cegs":
        path = str(tmp_path / "egs.ark")
        assert dataset_to_cegs(ds, path, batch_size=3) > 1
        ds = CegsDataset(path)
    L, caps = ds.estimate_live_arcs(), ds.estimate_sup_caps()
    batches = list(ds.batches(3, shuffle=False, sup_caps=caps))
    if source == "materialized_placed":
        assert set(_live_widths(batches)) == {L}
        return
    assert len(batches) > 1 and max(_live_widths(batches)) == L
    shapes = {DeviceSupervision.from_host(b.sup, device="cpu").with_kernel_tables(L_cap=L)
              .arcs_k.shape for b in batches}
    assert len(shapes) == 1


class _NoShape:
    """A dataset surface that fixes its supervision's padding only."""

    def estimate_sup_caps(self):
        return (4, 4, 8, 4)


@pytest.mark.parametrize("source", ["no_live_arcs", "no_sup_caps", "flat_start_materialized"])
def test_capture_refuses_a_dataset_without_one_shape(source):
    """(d): each of its batches would capture a graph of its own."""
    if source == "no_live_arcs":
        ds, match = _NoShape(), "no estimate_live_arcs"
    elif source == "no_sup_caps":
        ds, match = type("Bare", (), {"estimate_live_arcs": lambda self: 8})(), "no estimate_sup"
    else:
        c = tdata.synthetic_dataset(**CORPUS)
        e2e = tdata.E2eChainDataset(c.utts, c.tree, c.norm_fst, chunk_frames_out=6,
                                    left_context=2, right_context=2)
        ds, match = MaterializedBatches(e2e, 3), "flat-start"
        with pytest.raises(ValueError, match=match):
            ds.estimate_live_arcs()
        match = "estimate_sup_caps"
    with pytest.raises(ValueError, match=match):
        Trainer._shapes_of(ds)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
def test_a_device_scalar_rate_draws_the_float_rates_dropout(dtype):
    """(e)."""
    x = torch.randn(3, 7, 5, generator=torch.Generator().manual_seed(0)).to(dtype)
    gen = torch.Generator()
    outs = []
    for rate in (0.15, torch.tensor(0.15, dtype=torch.float32)):
        gen.manual_seed(11)
        outs.append(continuous_dropout(x, rate, True, gen))
    assert outs[0].dtype == outs[1].dtype == dtype
    assert torch.equal(outs[0], outs[1])
    assert not torch.equal(outs[0], x)


def test_capture_is_refused_where_it_cannot_run(jax_params):
    """(f)."""
    c = tdata.synthetic_dataset(**CORPUS)
    cfg = TdnnfConfig(num_pdfs=c.tree.num_pdfs, **TDNNF_SMALL)
    model = TDNNF(cfg, c.feat_dim, device="cpu")
    den = auto_den_graph(c.den_graph, device="cpu")
    with pytest.raises(ValueError, match="on cpu"):
        Trainer(model, den, TrainerConfig(capture=True, device="cpu"))
    model = _port_model(jax_params)
    state = ChainTrainState(model=model, optimizer=ChainOptimizer(
        model.parameters(), TrainerConfig(device="cpu")))
    with pytest.raises(ValueError, match="on cpu"):
        make_train_step(state, ChainLossOptions(**OPTS), capture=True,
                        update=lambda i, s: None)
    with pytest.raises(ValueError, match="on cpu"):
        make_backstitch_step(state, ChainLossOptions(**OPTS), 0.3, capture=True,
                             update=lambda i, s: None)
