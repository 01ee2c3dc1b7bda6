"""The data axis of the port (torchain_tpu_torch/parallel, ops/sharded.py
and the data-parallel paths of the batchnorms, dropout, chain loss and
loaders) on the CPU, under gloo.

`make_mesh` is held to the JAX package's sizes and errors; the loaders'
shards (`ChainDataset.batches`, `MaterializedBatches` with process_index /
process_count) to the global batch, field by field, and to the JAX
package's shards; the batchnorms, `chain_loss(mesh=)` and a dropout step on
two ranks (tools/multihost_worker.py, one process a rank, each waited on
with a timeout) to the one-rank computation on the same global batch.

Tolerances, float32: the batchnorms' outputs, input and parameter
gradients and running statistics 1e-6; the chain loss abs 1e-5 and its
gradient's L1 sum rel 1e-4 (tests/test_sharding.py's gates); the dropout
run's objf, loss and gradient norm rel 1e-5 a step.
"""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")

import torchain_tpu.data as jdata
from torchain_tpu.graphs import SupervisionOptions as JSupOpts
from torchain_tpu.parallel import MeshConfig as JMeshConfig
from torchain_tpu.parallel import make_mesh as j_make_mesh
import jax

import torchain_tpu_torch.parallel.mesh as mesh_mod
from torchain_tpu_torch.data import ChainDataset, MaterializedBatches, synthetic_dataset
from torchain_tpu_torch.graphs import SupervisionOptions
from torchain_tpu_torch.parallel import MeshConfig, make_mesh
from torchain_tpu_torch.tools import multihost_worker as mw

#: spawned ranks: few threads each (the suite runs several workers)
ENV = {"OMP_NUM_THREADS": "2"}
CORPUS = dict(num_utts=12, num_phones=5, feat_dim=8, seed=7)


@pytest.mark.parametrize("data,model", [(-1, 1), (1, 1), (2, 1), (-1, 2), (3, 2)])
def test_make_mesh_sizes_and_errors_are_the_jax_packages(data, model):
    """On one process (one device for the JAX function): the same shape,
    or the same ValueError."""
    try:
        want = dict(j_make_mesh(JMeshConfig(data=data, model=model), jax.devices()[:1]).shape)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            make_mesh(MeshConfig(data=data, model=model))
        assert str(got.value) == str(e)
        return
    assert make_mesh(MeshConfig(data=data, model=model)).shape == want


def _datasets():
    out = []
    for synth, cls, opts in ((synthetic_dataset, ChainDataset, SupervisionOptions),
                             (jdata.synthetic_dataset, jdata.ChainDataset, JSupOpts)):
        c = synth(**CORPUS)
        out.append(cls(c.utts, c.tree, c.norm_fst, chunk_frames_out=16, left_context=4,
                       right_context=4, sup_opts=opts(frame_subsampling_factor=3), seed=3))
    return out


def _array_fields(sup):
    return {f.name: getattr(sup, f.name) for f in dataclasses.fields(sup)
            if isinstance(getattr(sup, f.name), np.ndarray)}


def test_chain_dataset_shards_concatenate_to_the_global_batch():
    """Each of two ranks' batches, concatenated, is the global batch in
    every array field; each shard equals the JAX package's."""
    ds, jds = _datasets()
    caps = ds.estimate_sup_caps()
    assert tuple(caps) == tuple(jds.estimate_sup_caps())
    whole = list(ds.batches(4, epoch=0, sup_caps=caps))
    shards = [list(ds.batches(4, epoch=0, process_index=i, process_count=2, sup_caps=caps))
              for i in range(2)]
    jshards = [list(jds.batches(4, epoch=0, process_index=i, process_count=2, sup_caps=caps))
               for i in range(2)]
    assert len(whole) == len(shards[0]) == len(shards[1]) == len(jshards[0]) > 0
    for wb, s0, s1 in zip(whole, *shards):
        np.testing.assert_array_equal(wb.feats, np.concatenate([s0.feats, s1.feats]))
        w, a, b = _array_fields(wb.sup), _array_fields(s0.sup), _array_fields(s1.sup)
        assert set(w) == set(a) == set(b)
        for k, v in w.items():
            np.testing.assert_array_equal(v, np.concatenate([a[k], b[k]]), err_msg=k)
    for mine, theirs in zip(shards, jshards):
        for s, j in zip(mine, theirs):
            np.testing.assert_array_equal(s.feats, j.feats)
            np.testing.assert_array_equal(s.sup.in_logw, j.sup.in_logw)
            np.testing.assert_array_equal(np.asarray(s.sup.weight), np.asarray(j.sup.weight))


@pytest.mark.parametrize("kw", [dict(batch_size=5), dict(batch_size=4, caps=False),
                                dict(batch_size=4, drop_last=False)],
                         ids=["indivisible", "no_caps", "no_drop_last"])
def test_chain_dataset_shard_validation_is_the_jax_packages(kw):
    ds, jds = _datasets()
    caps = ds.estimate_sup_caps()
    call = dict(epoch=0, process_index=0, process_count=2,
                sup_caps=None if kw.get("caps") is False else caps,
                drop_last=kw.get("drop_last", True))
    with pytest.raises(ValueError) as want:
        next(jds.batches(kw["batch_size"], **call))
    with pytest.raises(ValueError) as got:
        next(ds.batches(kw["batch_size"], **call))
    assert str(got.value) == str(want.value)


def test_a_failed_supervision_becomes_a_weight_0_sibling_copy():
    """A chunk whose supervision does not compile keeps its row in its
    shard: a weight-0 copy of a sibling, as in the JAX package."""
    ds, jds = _datasets()
    caps = ds.estimate_sup_caps()
    first = next(ds.batches(4, epoch=0, sup_caps=caps, shuffle=False))
    bad = set()
    for d in (ds, jds):
        orig = d._sup_of
        # fail the second chunk of the first global batch's rank-0 rows
        groups = {}
        for i, c in enumerate(d.chunks):
            groups.setdefault(c[2], []).append(i)
        target = next(g for _, g in sorted(groups.items()) if len(g) >= 4)[1]
        bad.add(target)
        d._sup_of = (lambda o, t: lambda ci: None if ci == t else o(ci))(orig, target)
    got = next(ds.batches(4, epoch=0, process_index=0, process_count=2, sup_caps=caps,
                          shuffle=False))
    want = next(jds.batches(4, epoch=0, process_index=0, process_count=2, sup_caps=caps,
                            shuffle=False))
    assert len(bad) == 1 and got.feats.shape == (2, *first.feats.shape[1:])
    np.testing.assert_array_equal(np.asarray(got.sup.weight), np.asarray(want.sup.weight))
    assert sorted(np.asarray(got.sup.weight).tolist()) == [0.0, 1.0]
    np.testing.assert_array_equal(got.feats, want.feats)


def test_materialized_batches_take_the_process_arguments():
    """Each rank's materialized batches are its rows of the global ones, in
    the JAX class's replay order; device materialization under several
    processes and a sharded replay raise, as in the JAX class."""
    ds, jds = _datasets()
    whole = MaterializedBatches(ds, 4, seed=5)
    ranks = [MaterializedBatches(ds, 4, seed=5, process_index=i, process_count=2)
             for i in range(2)]
    jranks = [jdata.MaterializedBatches(jds, 4, seed=5, process_index=i, process_count=2)
              for i in range(2)]
    assert len(whole) == len(ranks[0]) == len(ranks[1]) == len(jranks[0])
    for epoch in (0, 3):
        seqs = [list(m.batches(4, epoch=epoch)) for m in (whole, *ranks, *jranks)]
        for w, a, b, ja, jb in zip(*seqs):
            np.testing.assert_array_equal(w.feats, np.concatenate([a.feats, b.feats]))
            np.testing.assert_array_equal(a.feats, ja.feats)
            np.testing.assert_array_equal(b.feats, jb.feats)
    with pytest.raises(ValueError, match="single-process"):
        MaterializedBatches(ds, 4, process_index=0, process_count=2, device="cpu")
    with pytest.raises(ValueError, match="materialization"):
        next(whole.batches(4, process_index=0, process_count=2))


@pytest.fixture(scope="module")
def batchnorms(tmp_path_factory):
    d = tmp_path_factory.mktemp("bn")
    mw.spawn(2, "bn", {"out": str(d / "two.npz")}, str(d), device="cpu", env=ENV)
    mw.run("bn", 0, 1, "cpu", {"out": str(d / "one.npz")})
    return np.load(d / "two.npz"), np.load(d / "one.npz")


@pytest.mark.parametrize("kind", ["fused", "flax", "brb_bypass"])
def test_batchnorm_over_two_ranks_is_the_global_batchs(batchnorms, kind):
    """Forward (outputs, running statistics) and backward (input and
    parameter gradients) of each batchnorm on two ranks' rows equal the
    one-rank batchnorm of the concatenated rows."""
    two, one = batchnorms
    keys = [k for k in one.files if k.startswith(kind + "_")]
    assert len(keys) >= 6
    for k in keys:
        np.testing.assert_allclose(two[k], one[k], rtol=0, atol=1e-6, err_msg=k)


def test_chain_loss_over_two_ranks_is_the_unsharded_loss(tmp_path):
    two = mw.spawn(2, "loss", {}, str(tmp_path), device="cpu", env=ENV)
    one = mw.run("loss", 0, 1, "cpu", {})
    assert two[0]["loss"] == two[1]["loss"]
    assert two[0]["weight"] == one["weight"] > 0
    assert two[0]["loss"] == pytest.approx(one["loss"], abs=1e-5)
    assert two[0]["grad_l1"] == pytest.approx(one["grad_l1"], rel=1e-4)
    assert two[0]["grad_sq"] == pytest.approx(one["grad_sq"], rel=1e-4)


def test_a_dropout_run_on_two_ranks_is_the_unsharded_run(tmp_path):
    """Dropout at rate 0.2 every step: each rank draws the global batch's
    masks and keeps its rows, so the two-rank curve is the one-rank one."""
    cfg = dict(trainer=dict(lr=1e-3, log_every=1, semi_ortho_every=0, dropout_schedule="0.2"),
               steps=4)
    two = mw.spawn(2, "trainer", cfg, str(tmp_path), device="cpu", env=ENV)
    one = mw.run("trainer", 0, 1, "cpu", cfg)
    plain = mw.run("trainer", 0, 1, "cpu", dict(cfg, trainer=dict(cfg["trainer"],
                                                                  dropout_schedule="")))
    assert len(two[0]["curve"]) == len(one["curve"]) == 4
    for a, b in zip(two[0]["curve"], one["curve"]):
        for k in ("objf", "loss", "grad_norm"):
            assert a[k] == pytest.approx(b[k], rel=1e-5), (a, b)
    # the masks moved the run: it is not the run without dropout
    assert any(abs(a["loss"] - c["loss"]) > 1e-4 for a, c in zip(one["curve"], plain["curve"]))
