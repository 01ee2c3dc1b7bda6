"""The port's multi-process data path (tools/multihost_worker.py, one
process a rank over gloo on the CPU, each waited on with a timeout) against
one process on the same global batches, as tests/test_multihost.py holds
the JAX package's, and against the JAX package's `Trainer`.

Tolerances are tests/test_multihost.py's: the loss abs 5e-6 (the ranks
among themselves 1e-6), the gradient's L1 sum rel 1e-5, the objf abs 5e-5;
a cegs run on two ranks takes half the steps over the same total weight.
The two-rank `Trainer` curve is held to the JAX `Trainer`'s on one process
from the same weights (convert.params_from_jax) at abs 5e-5 an objf a
step, and a two-rank run cut after 4 steps and resumed on two fresh ranks
to the uncut run bit for bit.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax
import torch

from torchain_tpu.data import ChainDataset as JChainDataset
from torchain_tpu.data import synthetic_dataset as j_synth
from torchain_tpu.graphs import SupervisionOptions as JSupOpts
from torchain_tpu.models import TDNNF as JTDNNF
from torchain_tpu.models import TdnnfConfig as JTdnnfConfig
from torchain_tpu.ops import ChainLossOptions as JOpts
from torchain_tpu.ops import auto_den_graph as j_auto_den
from torchain_tpu.train import Trainer as JTrainer
from torchain_tpu.train import TrainerConfig as JTrainerConfig
from torchain_tpu_torch.convert import params_from_jax
from torchain_tpu_torch.models import TdnnfConfig
from torchain_tpu_torch.tools import multihost_worker as mw

ENV = {"OMP_NUM_THREADS": "2"}


@pytest.fixture(scope="module")
def trainer_runs(tmp_path_factory):
    """The worker's trainer mode on two ranks (the uncut run, its
    parameters saved) and on one."""
    d = tmp_path_factory.mktemp("trainer")
    two = mw.spawn(2, "trainer", dict(save_params=str(d / "two.pt"), evaluate=True), str(d),
                   device="cpu", env=ENV)
    one = mw.run("trainer", 0, 1, "cpu", dict(evaluate=True))
    return two, one, torch.load(d / "two.pt", weights_only=True)["params"]


def test_two_rank_loss_matches_one_rank(tmp_path):
    two = mw.spawn(2, "loss", {}, str(tmp_path), device="cpu", env=ENV)
    assert two[0]["loss"] == pytest.approx(two[1]["loss"], abs=1e-6)
    one = mw.run("loss", 0, 1, "cpu", {})
    assert one["loss"] == pytest.approx(two[0]["loss"], abs=5e-6)
    assert one["grad_l1"] == pytest.approx(two[0]["grad_l1"], rel=1e-5)


def test_two_rank_trainer_fit_matches_one_rank(trainer_runs):
    two, one, _ = trainer_runs
    assert two[0]["objf"] == pytest.approx(two[1]["objf"], abs=1e-6)
    assert two[0]["failed"] == 0
    assert one["steps"] == two[0]["steps"] > 0
    assert one["weight"] == pytest.approx(two[0]["weight"])
    assert one["objf"] == pytest.approx(two[0]["objf"], abs=5e-5)


def test_two_rank_evaluate_reports_the_global_statistics(trainer_runs):
    """`Trainer.evaluate` after the run: the global batches scored on both
    ranks' rows (those of one row, which two ranks do not divide, whole on
    each) give one rank's statistics."""
    two, one, _ = trainer_runs
    assert two[0]["evaluated"] == two[1]["evaluated"]
    got, want = two[0]["evaluated"], one["evaluated"]
    assert got["batches"] == want["batches"] > 1
    assert got["weight"] == pytest.approx(want["weight"])
    assert got["objf"] == pytest.approx(want["objf"], abs=5e-5)


def test_two_rank_cegs_training_matches_one_rank(tmp_path):
    two = mw.spawn(2, "cegs", {}, str(tmp_path), device="cpu", env=ENV)
    assert two[0]["records"] == two[1]["records"] > 1
    assert two[0]["steps"] == two[1]["steps"] > 0
    assert two[0]["objf"] == pytest.approx(two[1]["objf"], abs=1e-6)
    assert two[0]["weight"] == pytest.approx(two[1]["weight"])
    one = mw.run("cegs", 0, 1, "cpu", {}, str(tmp_path))
    # two ranks take two records a global batch: half the steps, the same
    # data (total weight)
    assert one["steps"] == 2 * two[0]["steps"]
    assert one["weight"] == pytest.approx(two[0]["weight"])


def test_two_rank_trainer_curve_matches_the_jax_trainer(tmp_path):
    """The JAX Trainer on one process and the port's on two ranks, from
    the JAX model's initial weights, on the worker's corpus and batches."""
    d = mw.DEFAULTS
    corpus = j_synth(**d["corpus"])
    jcfg = JTdnnfConfig(num_pdfs=corpus.tree.num_pdfs, **d["model_cfg"])
    left, right = jcfg.context
    ds = JChainDataset(corpus.utts, corpus.tree, corpus.norm_fst,
                       chunk_frames_out=d["chunk_frames"], left_context=left,
                       right_context=right, sup_opts=JSupOpts(**d["sup_opts"]),
                       seed=d["data_seed"])
    tcfg = JTrainerConfig(lr=1e-3, num_epochs=1, batch_size=d["batch_size"], log_every=1,
                          semi_ortho_every=0, loss=JOpts(**d["loss"]))
    example = np.zeros((2, d["chunk_frames"] * 3 + left + right, corpus.feat_dim), np.float32)
    jtr = JTrainer(JTDNNF(jcfg), j_auto_den(corpus.den_graph), tcfg, example)
    params = jax.tree.map(np.asarray, jtr.state.params)
    stats = jax.tree.map(np.asarray, jtr.state.batch_stats)
    weights = tmp_path / "weights.pt"
    torch.save(params_from_jax(params, stats, TdnnfConfig(num_pdfs=corpus.tree.num_pdfs,
                                                          **d["model_cfg"])), weights)
    jtr.fit(ds, log_fn=lambda s: None)
    two = mw.spawn(2, "trainer", dict(weights=str(weights)), str(tmp_path), device="cpu", env=ENV)
    want = [m["objf"] for m in jtr.metrics_log]
    for r in two:
        got = [m["objf"] for m in r["curve"]]
        assert len(got) == len(want) > 0
        np.testing.assert_allclose(got, want, rtol=0, atol=5e-5)


def test_two_rank_cut_and_resume_is_the_uncut_run(tmp_path, trainer_runs):
    two, _, uncut_params = trainer_runs
    ck = dict(checkpoint_dir=str(tmp_path / "ck"))
    first = mw.spawn(2, "trainer", dict(ck, steps=4), str(tmp_path), device="cpu", env=ENV)
    rest = mw.spawn(2, "trainer", dict(ck, restore=True, save_params=str(tmp_path / "r.pt")),
                    str(tmp_path), device="cpu", env=ENV)
    assert first[0]["curve"] == two[0]["curve"][:4]
    assert [m["step"] for m in rest[0]["curve"]] == list(range(5, len(two[0]["curve"]) + 1))
    assert rest[0]["curve"] == rest[1]["curve"] == two[0]["curve"][4:]
    resumed = torch.load(tmp_path / "r.pt", weights_only=True)["params"]
    for k, v in uncut_params.items():
        assert torch.equal(resumed[k], v), k
