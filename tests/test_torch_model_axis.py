"""The model axis of the port (torchain_tpu_torch/parallel/sharding.py, the
2-D `make_mesh`, the conformer's split feed-forward and the sharded step)
on the CPU, under gloo.

The rules are held to `torchain_tpu.parallel.param_sharding_rules` leaf by
leaf (the JAX side through `jax.eval_shape`, the port's on the meta
device); the 2-D layout to the JAX mesh's device reshape; four spawned
ranks, data 2 x model 2 (tools/multihost_worker.py `model` mode, one
process a rank, each waited on with a timeout), to the JAX sharded step of
tests/test_sharding.py on a 2 x 2 mesh of the CPU devices from the same
weights and batch, at that test's gates (the conformer: loss abs 2e-4,
gradient norm rel 1e-3; the TDNN-F: abs 1e-5, rel 1e-4), and to the
port's one-rank step at abs 1e-5 / rel 1e-4.  After the step the gathered
parameters are held to the one-rank step's at rel 1e-5 of each leaf's
largest magnitude (under Adam on the elements whose step the gradient
sets: where a gradient is zero but for the float32 order of the batch's
sums, Adam's g / (|g| + eps) turns that order into a step of up to lr in
either run); NGSGD and max-change act on the sharded leaves as on the
whole ones (the same gate on every element, two steps).
"""

import functools

import numpy as np
import pytest

pytest.importorskip("jax")

import jax
import jax.numpy as jnp
import optax
import torch

from torchain_tpu.data import ChainDataset as JChainDataset
from torchain_tpu.data import synthetic_dataset as j_synth
from torchain_tpu.graphs import SupervisionOptions as JSupOpts
from torchain_tpu.models import Conformer as JConformer
from torchain_tpu.models import ConformerConfig as JConformerConfig
from torchain_tpu.models import TDNNF as JTDNNF
from torchain_tpu.models import TdnnfConfig as JTdnnfConfig
from torchain_tpu.ops import ChainLossOptions as JOpts
from torchain_tpu.ops import DeviceDenseDenGraph as JDenseDen
from torchain_tpu.ops.device_graphs import DeviceSupervision as JSup
from torchain_tpu.parallel import MeshConfig as JMeshConfig
from torchain_tpu.parallel import batch_sharding, replicated
from torchain_tpu.parallel import make_mesh as j_make_mesh
from torchain_tpu.parallel import param_sharding_rules as j_rules
from torchain_tpu.parallel import shard_params as j_shard_params
from torchain_tpu.train import create_train_state as j_state
from torchain_tpu.train import make_train_step as j_train_step

import torchain_tpu_torch.parallel.mesh as mesh_mod
from torchain_tpu_torch.convert import _flatten, params_from_jax
from torchain_tpu_torch.models import TDNNF, Conformer, ConformerConfig, TdnnfConfig
from torchain_tpu_torch.parallel import Mesh, MeshConfig, make_mesh, mesh_layout, param_sharding_rules
from torchain_tpu_torch.tools import multihost_worker as mw

ENV = {"OMP_NUM_THREADS": "1"}

#: tests/test_sharding.py's two problems, as the worker's configs
CONFORMER = dict(corpus=dict(num_utts=8, num_phones=4, feat_dim=8, seed=5), chunk_frames=10,
                 sup_opts=dict(left_tolerance=1, right_tolerance=1), batch_size=4,
                 model="conformer", model_cfg=dict(dim=64, num_layers=2, num_heads=2,
                                                   prefinal_dim=32),
                 min_shard_size=256, den="dense", loss=dict(leaky_hmm_coefficient=0.1))
TDNNF_TINY = dict(corpus=dict(num_utts=16, num_phones=5, feat_dim=16, utt_frames_out=[12, 20],
                              context_width=1, seed=0, lm_order=2, lm_extra_states=200),
                  chunk_frames=12, sup_opts=dict(left_tolerance=1, right_tolerance=1),
                  batch_size=8, model="tdnnf",
                  model_cfg=dict(hidden_dim=64, bottleneck_dim=16, prefinal_dim=32, num_layers=3),
                  min_shard_size=1024, den="dense", loss=dict(leaky_hmm_coefficient=0.1))


# ---------------------------------------------------------------------------
# the rules, leaf by leaf
# ---------------------------------------------------------------------------

#: (JAX model, port model) builders by case: the dim-64 conformer and the
#: tiny TDNN-F of tests/test_sharding.py, and both at full width (1000 pdfs)
MODELS = {
    "conformer64": (lambda: JConformer(JConformerConfig(num_pdfs=20, dim=64, num_layers=2,
                                                        num_heads=2, prefinal_dim=32)),
                    lambda: Conformer(ConformerConfig(num_pdfs=20, dim=64, num_layers=2,
                                                      num_heads=2, prefinal_dim=32), 8,
                                      device="meta"), 8, 256),
    "tdnnf_tiny": (lambda: JTDNNF(JTdnnfConfig(num_pdfs=30, hidden_dim=64, bottleneck_dim=16,
                                               prefinal_dim=32, num_layers=3)),
                   lambda: TDNNF(TdnnfConfig(num_pdfs=30, hidden_dim=64, bottleneck_dim=16,
                                             prefinal_dim=32, num_layers=3), 16, device="meta"),
                   16, 1024),
    "conformer_full": (lambda: JConformer(JConformerConfig(num_pdfs=1000)),
                       lambda: Conformer(ConformerConfig(num_pdfs=1000), 40, device="meta"),
                       40, 2**18),
    "tdnnf_full": (lambda: JTDNNF(JTdnnfConfig(num_pdfs=1000, hidden_dim=768, bottleneck_dim=96,
                                               prefinal_dim=256, num_layers=9)),
                   lambda: TDNNF(TdnnfConfig(num_pdfs=1000, hidden_dim=768, bottleneck_dim=96,
                                             prefinal_dim=256, num_layers=9), 40, device="meta"),
                   40, 2**18),
}


@functools.lru_cache(maxsize=None)
def _shapes(case):
    """The JAX model's parameter shapes (no arrays) and the port's model on
    the meta device."""
    jmodel, tmodel, feat, _ = MODELS[case]
    example = jnp.zeros((2, 60, feat), jnp.float32)
    with torch.device("meta"):
        port = tmodel()
    shapes = jax.eval_shape(lambda: jmodel().init(jax.random.PRNGKey(0), example, train=False))
    return shapes["params"], port


def _axis(spec) -> int | None:
    axes = [i for i, a in enumerate(tuple(spec)) if a == "model"]
    return axes[0] if axes else None


@pytest.mark.parametrize("m", [1, 2, 3, 4])
@pytest.mark.parametrize("case", list(MODELS))
def test_sharding_rules_are_the_jax_packages_leaf_by_leaf(case, m):
    """Every leaf's decision (the axis sharded over "model", or none) is the
    JAX rule's, on a model axis of m.  3 divides no leaf at full width (all
    replicated); at dim 64 it divides the qkv kernels' 192 columns."""
    params, port = _shapes(case)
    min_size = MODELS[case][3]
    jmesh = jax.sharding.Mesh(np.asarray(jax.devices()[:m]).reshape(1, m), ("data", "model"))
    want = {k: _axis(v.spec) for k, v in _flatten(j_rules(jmesh, params, min_size)).items()}
    got = param_sharding_rules(Mesh(shape=dict(data=1, model=m)), port, min_size)
    assert set(got) == set(want)
    assert got == want
    sharded = sum(v is not None for v in got.values())
    if m == 3 and case.endswith("_full"):
        assert sharded == 0
    elif m in (2, 4) and case != "tdnnf_full":
        assert sharded > 0
    if case == "conformer_full" and m == 2:
        # exactly the 32 feed-forward kernels: W1 by columns, W2 by rows
        assert sorted(k for k, v in got.items() if v is not None) == sorted(
            f"block{i}.ffn{j}_{io}.kernel" for i in range(8) for j in (1, 2)
            for io in ("in", "out"))
        assert all(got[k] == (1 if "_in." in k else 0) for k, v in got.items() if v is not None)


@pytest.mark.parametrize("data,model", [(1, 2), (2, 2), (4, 2), (2, 4), (1, 8), (8, 1)])
def test_mesh_layout_is_the_jax_device_reshape(data, model):
    jm = j_make_mesh(JMeshConfig(data=data, model=model), jax.devices()[:data * model])
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    np.testing.assert_array_equal(mesh_layout(data, model), ids - ids.min())


@pytest.mark.parametrize("data,model", [(3, 2), (-1, 3), (2, 3), (1, 2)])
def test_make_mesh_errors_on_four_processes_are_the_jax_packages(monkeypatch, data, model):
    """The sizes a world of four cannot hold raise the JAX function's error
    on four devices (1 x 2 is the one layout of the list a world of two
    holds: on four it raises too)."""
    with pytest.raises(ValueError) as want:
        j_make_mesh(JMeshConfig(data=data, model=model), jax.devices()[:4])
    monkeypatch.setattr(mesh_mod, "world_size", lambda: 4)
    with pytest.raises(ValueError) as got:
        make_mesh(MeshConfig(data=data, model=model))
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# the sharded step on four ranks
# ---------------------------------------------------------------------------


def _jax_problem(c: dict):
    """The JAX model, its initial train state, and the global batch and
    dense den graph of the worker's config (the same corpus and rows)."""
    corpus = j_synth(**{k: tuple(v) if isinstance(v, list) else v
                        for k, v in c["corpus"].items()})
    if c["model"] == "conformer":
        cfg = JConformerConfig(num_pdfs=corpus.tree.num_pdfs, **c["model_cfg"])
        model = JConformer(cfg)
    else:
        cfg = JTdnnfConfig(num_pdfs=corpus.tree.num_pdfs, **c["model_cfg"])
        model = JTDNNF(cfg)
    left, right = cfg.context
    ds = JChainDataset(corpus.utts, corpus.tree, corpus.norm_fst,
                       chunk_frames_out=c["chunk_frames"], left_context=left,
                       right_context=right, sup_opts=JSupOpts(**c["sup_opts"]),
                       seed=mw.DEFAULTS["data_seed"])
    batch = next(ds.batches(c["batch_size"], shuffle=False))
    feats = jnp.asarray(batch.feats)
    state = j_state(model, feats, optax.adam(1e-3))
    return corpus, cfg, state, feats, JSup.from_host(batch.sup), JDenseDen.from_host(
        corpus.dense_den)


def _jax_sharded_step(c: dict, weights_path):
    """tests/test_sharding.py's sharded step on a data 2 x model 2 mesh of
    the CPU devices; the initial weights are written for the port."""
    corpus, cfg, state, feats, sup, den = _jax_problem(c)
    port_cfg = (ConformerConfig if c["model"] == "conformer" else TdnnfConfig)(
        num_pdfs=corpus.tree.num_pdfs, **c["model_cfg"])
    params = jax.tree.map(np.asarray, state.params)
    stats = jax.tree.map(np.asarray, state.batch_stats)
    torch.save(params_from_jax(params, stats, port_cfg), weights_path)
    step_fn = j_train_step(JOpts(leaky_hmm_coefficient=0.1), donate=False)
    mesh = j_make_mesh(JMeshConfig(data=2, model=2), jax.devices()[:4])
    with mesh:
        sharded = state.replace(
            params=j_shard_params(mesh, state.params, min_shard_size=c["min_shard_size"]),
            batch_stats=jax.device_put(state.batch_stats, replicated(mesh)),
            opt_state=jax.device_put(state.opt_state, replicated(mesh)))
        _, m = step_fn(sharded, jax.device_put(feats, batch_sharding(mesh, 3)),
                       jax.device_put(den, replicated(mesh)),
                       jax.tree.map(lambda x: jax.device_put(x, batch_sharding(mesh, x.ndim)),
                                    sup))
    return dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]))


#: the variants of the four-rank run, in order: both feed-forward lowerings
#: of the conformer, the TDNN-F, and the TDNN-F under NGSGD with max-change
#: (two steps)
NGSGD = dict(optimizer="ngsgd", lr=1e-2, max_change_per_component=0.05, max_param_change=0.08,
             log_every=1, semi_ortho_every=0)
VARIANTS = ["dense", "fused", "tdnnf", "tdnnf_ngsgd", "tdnn", "tdnn_lstm", "cnn_tdnn",
            "dense_bf16", "fused_bf16"]
#: the float32 variants, whose parameters after the step are held element by
#: element
F32_VARIANTS = VARIANTS[:7]
#: the other trunks at small widths on the TDNN-F's corpus, at a threshold
#: that shards their larger leaves (every one gathered on use)
TRUNKS = {
    "tdnn": dict(model="tdnn", model_cfg=dict(hidden_dim=32, prefinal_dim=16)),
    "tdnn_lstm": dict(model="tdnn-lstm", model_cfg=dict(hidden_dim=32, cell_dim=32,
                                                        rec_proj_dim=8, nonrec_proj_dim=8,
                                                        prefinal_dim=16)),
    "cnn_tdnn": dict(model="cnn-tdnn", model_cfg=dict(feat_dim=16, conv_filters=(4, 4, 8, 8, 8, 16),
                                                      hidden_dim=32, bottleneck_dim=8,
                                                      prefinal_dim=16, num_tdnnf_layers=2)),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX sharded steps, the four-rank worker run of every variant and
    the one-rank run of the same variants."""
    d = tmp_path_factory.mktemp("model_axis")
    jax_out = {"conformer": _jax_sharded_step(CONFORMER, d / "conformer.pt"),
               "tdnnf": _jax_sharded_step(TDNNF_TINY, d / "tdnnf.pt")}
    conf = dict(CONFORMER, weights=str(d / "conformer.pt"))
    tdnnf = dict(TDNNF_TINY, weights=str(d / "tdnnf.pt"))
    variants = [conf, dict(conf, model_cfg=dict(conf["model_cfg"], ffn_impl="fused")), tdnnf,
                dict(tdnnf, trainer=NGSGD, steps=2),
                *(dict(TDNNF_TINY, min_shard_size=256, **TRUNKS[k]) for k in VARIANTS[4:7]),
                *(dict(conf, model_cfg=dict(conf["model_cfg"], ffn_impl=impl, dtype="bfloat16"))
                  for impl in ("dense", "fused"))]
    base = dict(variants=variants, save_params=str(d / "four.pt"), mesh=dict(data=2, model=2))
    four = mw.spawn(4, "model", base, str(d), device="cpu", env=ENV, timeout=300)
    one = mw.run("model", 0, 1, "cpu", dict(base, save_params=str(d / "one.pt"),
                                            mesh=dict(data=1, model=1)))
    saved = {name: (torch.load(f"{d / 'four.pt'}.{i}", weights_only=True),
                    torch.load(f"{d / 'one.pt'}.{i}", weights_only=True))
             for i, name in enumerate(VARIANTS)}
    return jax_out, four, one, saved


def test_the_ranks_take_their_places_on_the_jax_mesh(runs):
    """Each rank's (data rank, model rank) is its place in the JAX mesh's
    device reshape (2, 2)."""
    _, four, _, _ = runs
    jm = j_make_mesh(JMeshConfig(data=2, model=2), jax.devices()[:4])
    ids = np.vectorize(lambda dv: dv.id)(jm.devices)
    ids = ids - ids.min()
    for r in four:
        p = r["mesh"]
        assert ids[p["data_rank"], p["model_rank"]] == p["global_rank"]
        assert p["shape"] == dict(data=2, model=2)


@pytest.mark.parametrize("name", ["dense", "fused"])
def test_four_ranks_reproduce_the_jax_sharded_conformer_step(runs, name):
    jax_out, four, one, _ = runs
    i = VARIANTS.index(name)
    got = [r["variants"][i] for r in four]
    assert len({g["loss"] for g in got}) == 1
    want = jax_out["conformer"]
    assert got[0]["loss"] == pytest.approx(want["loss"], abs=2e-4)
    assert got[0]["grad_norm"] == pytest.approx(want["grad_norm"], rel=1e-3)
    ref = one["variants"][i]
    assert got[0]["loss"] == pytest.approx(ref["loss"], abs=1e-5)
    assert got[0]["grad_norm"] == pytest.approx(ref["grad_norm"], rel=1e-4)
    # the feed-forward kernels are split (F 256 / 2 a rank); every other
    # sharded leaf is gathered on use
    shapes = got[0]["shard_shapes"]
    assert shapes["block0.ffn1_in.kernel"] == [64, 128]
    assert shapes["block1.ffn2_out.kernel"] == [128, 64]
    assert "block0.attn_qkv.kernel" in shapes


def test_four_ranks_reproduce_the_jax_sharded_tdnnf_step(runs):
    jax_out, four, one, _ = runs
    i = VARIANTS.index("tdnnf")
    got = [r["variants"][i] for r in four]
    want = jax_out["tdnnf"]
    assert got[0]["loss"] == pytest.approx(want["loss"], abs=1e-5)
    assert got[0]["grad_norm"] == pytest.approx(want["grad_norm"], rel=1e-4)
    ref = one["variants"][i]
    assert got[0]["loss"] == pytest.approx(ref["loss"], abs=1e-5)
    assert got[0]["grad_norm"] == pytest.approx(ref["grad_norm"], rel=1e-4)
    assert len(got[0]["sharded"]) > 0


#: Adam's first step is lr * g / (|g| + eps): on an element whose gradient
#: is at least this (1e4 eps) a gradient noise of 1e-8 moves it by 1e-11;
#: below it (the structurally zero gradients, as of attention's key bias or
#: a bias before a batchnorm, sit at 1e-8) eps and the float32 order of the
#: batch's sums set the step, which is at most lr
ADAM_FIRM = 1e-4


@pytest.mark.parametrize("name", list(TRUNKS))
def test_every_other_trunk_gathers_its_sharded_leaves_on_use(runs, name):
    """The plain TDNN, the TDNN-LSTM and the CNN-TDNN with leaves sharded
    at a low threshold, each gathered before its module's forward: four
    ranks take the one-rank step (loss abs 1e-5, gradient norm rel 1e-4)."""
    _, four, one, _ = runs
    i = VARIANTS.index(name)
    got, ref = [r["variants"][i] for r in four], one["variants"][i]
    assert len(got[0]["sharded"]) > 0
    assert got[0]["collectives_per_step"]["model"]["all_gather"] > 0
    assert len({g["loss"] for g in got}) == 1
    assert got[0]["loss"] == pytest.approx(ref["loss"], abs=1e-5)
    assert got[0]["grad_norm"] == pytest.approx(ref["grad_norm"], rel=1e-4)


def _amax(t) -> float:
    return float(t.max()) if t.numel() else 0.0


@pytest.mark.parametrize("name", F32_VARIANTS)
def test_gathered_parameters_after_the_step_are_the_one_rank_steps(runs, name):
    """Adam (NGSGD with max-change for the last variant, two steps) on the
    shards moves each leaf as the one-rank step moves the whole leaf: rel
    1e-5 of the leaf's largest magnitude, under Adam on the elements whose
    step the gradient sets (ADAM_FIRM; elsewhere each run steps at most lr);
    the first step's gathered gradients within 1e-6 of the gradient's
    norm, element by element."""
    _, four, one, saved = runs
    (got, want), i = saved[name], VARIANTS.index(name)
    adam = name != "tdnnf_ngsgd"
    norm = one["variants"][i]["grad_norm"]
    assert set(got["params"]) == set(want["params"])
    for k, v in want["params"].items():
        assert got["params"][k].shape == v.shape, k
        d = (got["params"][k] - v).abs()
        if k in want["first_grads"]:
            assert float((got["first_grads"][k] - want["first_grads"][k]).abs().max()) <= (
                1e-6 * norm), k
            if adam:
                firm = want["first_grads"][k].abs() >= ADAM_FIRM
                assert _amax(d[~firm]) <= 2e-3, k  # each run's step at most lr
                d = d[firm]
        assert _amax(d) <= 1e-5 * max(float(v.abs().max()), 1e-30), k
    for a, b in zip(four[0]["variants"][i]["curve"], one["variants"][i]["curve"]):
        assert a["loss"] == pytest.approx(b["loss"], abs=1e-5)
        assert a["grad_norm"] == pytest.approx(b["grad_norm"], rel=1e-4)


@pytest.mark.parametrize("impl", ["dense", "fused"])
def test_a_bfloat16_conformer_split_over_the_model_group_is_the_one_rank_step(runs, impl):
    """The bf16 trunk: the split half-steps keep their partials float32 to
    the model group's sum, so four ranks take the one rank's first step
    within the bf16 reference gate (1e-2, chip_smoke.py's REFERENCE_RTOL)
    in loss, objf and gradient norm."""
    _, four, one, _ = runs
    i = VARIANTS.index(f"{impl}_bf16")
    got, ref = four[0]["variants"][i], one["variants"][i]
    for k in ("loss", "objf", "grad_norm"):
        assert got[k] == pytest.approx(ref[k], rel=1e-2), k
    assert got["shard_shapes"]["block0.ffn1_in.kernel"] == [64, 128]


def test_each_rank_holds_its_share_of_the_parameters_and_moments(runs):
    """A sharded leaf's bytes are halved on each of the two model ranks, in
    the parameters and in Adam's moments; the collectives of a step go to
    their groups."""
    _, four, one, _ = runs
    i = VARIANTS.index("dense")
    got, ref = four[0]["variants"][i], one["variants"][i]
    half = sum(int(np.prod(v)) for v in got["shard_shapes"].values())
    assert ref["param_bytes"] - got["param_bytes"] == 4 * half
    assert got["opt_state_bytes"] < ref["opt_state_bytes"]
    stats = got["collectives_per_step"]
    # per half-step one all-reduce forward, one backward; the b1 sums; the
    # gradient norm and the clip's
    assert stats["model"]["all_reduce"] == 2 * 2 * 2 + 1 + 2
    assert stats["model"]["all_gather"] > 0
    assert stats["data"]["all_reduce"] > 0 and stats["data"]["all_gather"] == 0
    assert ref["collectives_per_step"]["model"]["all_reduce"] == 0


@pytest.mark.parametrize("rank", [0, 1])
def test_a_whole_state_dict_loads_into_a_sharded_model(rank):
    """`load_gathered_state_dict`: whole tensors (a checkpoint, or the JAX
    weights through `convert.params_from_jax`) go into a model sharded for
    model rank `rank` of 2 as that rank's blocks, the replicated leaves
    whole; the sharded parameters keep the whole leaf's shape beside
    their own.  (Sharding and loading make no collective.)"""
    from torchain_tpu_torch.parallel import load_gathered_state_dict, shard_params
    from torchain_tpu_torch.parallel.sharding import full_shape, model_axis

    cfg = ConformerConfig(num_pdfs=20, dim=64, num_layers=2, num_heads=2, prefinal_dim=32)
    jm = JConformer(JConformerConfig(num_pdfs=20, dim=64, num_layers=2, num_heads=2,
                                     prefinal_dim=32))
    v = jm.init(jax.random.PRNGKey(3), jnp.zeros((2, 60, 8), jnp.float32), train=False)
    whole_sd = params_from_jax(jax.tree.map(np.asarray, v["params"]),
                               jax.tree.map(np.asarray, v["batch_stats"]), cfg)
    mesh = Mesh(shape=dict(data=1, model=2), model_rank=rank)
    model = shard_params(mesh, Conformer(cfg, 8, device="cpu"), min_shard_size=256)
    load_gathered_state_dict(model, whole_sd)
    params = dict(model.named_parameters())
    sharded = [k for k, p in params.items() if model_axis(p) is not None]
    assert "block0.ffn1_in.kernel" in sharded and "block0.attn_qkv.kernel" in sharded
    for k, want in whole_sd.items():
        got = params[k].detach() if k in params else model.state_dict()[k]
        axis = model_axis(params[k]) if k in params else None
        if axis is not None:
            assert full_shape(params[k]) == tuple(want.shape)
            n = want.shape[axis] // 2
            want = want.narrow(axis, rank * n, n)
        assert torch.equal(got, want), k


def test_the_trainer_on_a_model_axis_is_the_one_rank_trainer(tmp_path):
    """`Trainer.fit` on four ranks as data 2 x model 2 (the JAX `Trainer`'s
    model axis: each data rank's rows, the state replicated over the model
    group) trains the one-rank curve (objf abs 5e-5 a step, as the
    two-rank data axis); the ranks of a model group agree bit for bit, and
    global rank 0 alone writes the checkpoint."""
    ck = tmp_path / "ck"
    cfg = dict(mesh=dict(data=2, model=2), steps=4, checkpoint_dir=str(ck))
    four = mw.spawn(4, "trainer", cfg, str(tmp_path), device="cpu", env=ENV, timeout=300)
    one = mw.run("trainer", 0, 1, "cpu", dict(cfg, mesh=dict(data=1, model=1),
                                              checkpoint_dir=None))
    assert four[0]["curve"] == four[1]["curve"] and four[2]["curve"] == four[3]["curve"]
    assert len(four[0]["curve"]) == len(one["curve"]) == 4
    for a, b in zip(four[0]["curve"], one["curve"]):
        assert a["objf"] == pytest.approx(b["objf"], abs=5e-5)
        assert a["weight"] == b["weight"]
    assert sorted(p.name for p in ck.iterdir() if p.name.isdigit()) == ["4"]
    assert four[0]["collectives_per_step"]["model"]["all_reduce"] == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_the_split_half_steps_shares_sum_to_the_whole_one(dtype):
    """K10's plain versions with `partial`: the float32 shares of two halves
    of the hidden columns, summed, then the residual and b2 added and
    rounded once, give the unsplit half-step (float32 to 1e-6; bf16 within
    one rounding step of its output, sums in another order); the shares of
    dx summed and rounded once give its dx the same way, and each share's
    weight gradients are the whole one's columns or rows."""
    from torchain_tpu_torch.ops.fused_ffn import ffn_backward_plain, ffn_forward_plain

    rng = np.random.default_rng(4)
    N, D, F = 48, 16, 64

    def t(*shape, scale=1.0):
        return torch.tensor(rng.standard_normal(shape).astype(np.float32) * scale)

    xn, res, g = t(N, D).to(dtype), t(N, D).to(dtype), t(N, D).to(dtype)
    w1, w2 = t(D, F, scale=D ** -0.5).to(dtype), t(F, D, scale=F ** -0.5).to(dtype)
    b1, b2 = t(F, scale=0.1), t(D, scale=0.1)
    whole = ffn_forward_plain(xn, res, w1, b1, w2, b2, 0.5)
    halves = [slice(0, F // 2), slice(F // 2, F)]
    parts = sum(ffn_forward_plain(xn, None, w1[:, h], b1[h], w2[h], None, 0.5, partial=True)
                for h in halves)
    split = (res.float() + (parts + 0.5 * b2)).to(dtype)
    step = 1e-6 if dtype == torch.float32 else 2.0 ** -7
    assert float((split.float() - whole.float()).abs().max()) <= step * float(
        whole.float().abs().max())
    dx, dw1, db1, dw2, _ = ffn_backward_plain(xn, g, w1, b1, w2, 0.5)
    shares = [ffn_backward_plain(xn, g, w1[:, h], b1[h], w2[h], 0.5, partial=True)
              for h in halves]
    assert all(sh[0].dtype == torch.float32 for sh in shares)
    dx_split = sum(sh[0] for sh in shares).to(dtype)
    assert float((dx_split.float() - dx.float()).abs().max()) <= step * float(
        dx.float().abs().max())
    for h, sh in zip(halves, shares):
        torch.testing.assert_close(sh[1], dw1[:, h], rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(sh[2], db1[h], rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(sh[3], dw2[h], rtol=1e-6, atol=1e-6)
