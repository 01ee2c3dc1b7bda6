"""The port's recipe entry points on the CPU (`--device cpu`):
cli/train.py on the synthetic corpus (TDNN-F, flat-start `--e2e`, the
conformer, the plain TDNN, the frame-shift cycle with a dropout schedule
under SGD, and backstitch; each loss falls and each --metrics-out line
carries the JAX CLI's keys), on a Kaldi prep (merged cegs + binary
den.fst, tests/test_cegs_train.py's `_kaldi_prep`) cut by --epochs and
resumed to --steps; cli/compute_prob.py and
cli/export_posteriors.py against the JAX package's tools; and the
refusal to run without a card unless asked for the CPU.

The JAX tools evaluate and export a random init drawn from
PRNGKey(0) (create_train_state).  The port's tools read a port checkpoint
written from that same init (convert.params_from_jax), so the two compute
the same function: compute_prob's objf, l2 and xent per frame are held to
rtol 1e-4 (float32 sums over the batch in another order), the exported
matrices to atol 1e-5 (float32 matmuls through a few layers of
batchnorm).
"""

import json

import numpy as np
import pytest

pytest.importorskip("jax")

import jax
import jax.numpy as jnp
import torch

from tests.test_cegs_train import _kaldi_prep
from torchain_tpu_torch.cli.compute_prob import main as cp_main
from torchain_tpu_torch.cli.export_posteriors import main as export_main
from torchain_tpu_torch.cli.train import main as train_main

#: the keys of each --metrics-out line of the JAX CLI (Trainer.metrics_log:
#: the chain loss's statistics, loss and gradient norm, the step's place and
#: the clocks); tests/test_torch_trainer.py holds the port Trainer's log
#: entries to the JAX Trainer's, key for key
JAX_METRIC_KEYS = {"objf", "l2_term", "oor_term", "xent_objf", "weight", "num_failed", "loss",
                   "grad_norm", "step", "epoch", "wall_s", "frames_per_s"}
SMALL = ["--hidden-dim", "32", "--bottleneck-dim", "8", "--num-layers", "2"]


def _metrics(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _falls(lines):
    losses = [m["loss"] for m in lines]
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0], losses


@pytest.mark.parametrize(
    "extra",
    [[], ["--e2e"], ["--model", "conformer"], ["--model", "tdnn"],
     ["--frame-shift-cycle", "--dropout-schedule", "0,0.3@0.5,0", "--optimizer", "sgd",
      "--lr", "2e-2"],
     ["--backstitch-scale", "0.3", "--optimizer", "sgd", "--lr", "2e-2"]],
    ids=["tdnnf", "e2e", "conformer", "tdnn", "frame_shift_dropout_sgd", "backstitch"])
def test_train_cli_on_the_synthetic_corpus(tmp_path, extra):
    out = str(tmp_path / "m.jsonl")
    res = train_main(["--synthetic", "--device", "cpu", "--num-utts", "8", "--batch-size", "4",
                      "--epochs", "4", "--lr", "3e-3", "--log-every", "1", "--metrics-out", out,
                      "--seed", "1", "--chunk-frames", "20", *SMALL, *extra])
    lines = _metrics(out)
    assert res["steps"] == len(lines) >= 4
    assert all(set(m) == JAX_METRIC_KEYS for m in lines)
    assert [m["step"] for m in lines] == list(range(1, res["steps"] + 1))
    _falls(lines)


def test_train_cli_from_a_kaldi_prep_resumes_where_it_stopped(tmp_path):
    paths, den_path, _tree, _g = _kaldi_prep(tmp_path, n_archives=1, records_per=1)
    ck, out = str(tmp_path / "ck"), str(tmp_path / "m.jsonl")
    common = ["--cegs", paths[0], "--den-fst", den_path, "--model", "tdnnf", *SMALL,
              "--device", "cpu", "--log-every", "1", "--checkpoint-dir", ck,
              "--lr-final", "1e-4", "--steps", "5", "--metrics-out", out]
    res = train_main([*common, "--epochs", "3"])
    assert res["steps"] == 3  # one record an epoch
    first = _metrics(out)
    res = train_main([*common, "--epochs", "6"])
    assert res["steps"] == 5  # stopped by --steps
    second = _metrics(out)
    assert [m["step"] for m in second] == [4, 5]
    _falls(first + second)
    assert res["timings"]["ckpt_read"] and res["timings"]["ckpt_write"][-1][0] == 5


def _jax_init(cfg, example):
    from torchain_tpu.models import TDNNF as JTDNNF

    v = JTDNNF(cfg).init(jax.random.PRNGKey(0), jnp.asarray(example), train=False)
    return v["params"], v["batch_stats"]


def _port_checkpoint(ck, tcfg, feat_dim, params, stats, den):
    """A port checkpoint of the JAX tools' init, fingerprinted with `den`."""
    from torchain_tpu_torch.convert import params_from_jax
    from torchain_tpu_torch.models import TDNNF
    from torchain_tpu_torch.train import Trainer, TrainerConfig

    model = TDNNF(tcfg, feat_dim, device="cpu")
    model.load_state_dict(params_from_jax(params, stats, tcfg))
    Trainer(model, den, TrainerConfig(checkpoint_dir=ck, device="cpu")).save_checkpoint()


def test_compute_prob_matches_the_jax_tool(tmp_path):
    from torchain_tpu.cli.compute_prob import main as j_cp_main
    from torchain_tpu.models import TdnnfConfig as JCfg
    from torchain_tpu_torch.cli.graphs import _load_any_fst
    from torchain_tpu_torch.data import CegsDataset
    from torchain_tpu_torch.graphs import compile_den_graph
    from torchain_tpu_torch.models import TdnnfConfig
    from torchain_tpu_torch.ops import auto_den_graph

    paths, den_path, _tree, _g = _kaldi_prep(tmp_path, n_archives=1, records_per=2)
    common = ["--cegs", paths[0], "--den-fst", den_path, "--model", "tdnnf", *SMALL]
    want = j_cp_main(common)

    feat_dim, P, _bsz, _t = CegsDataset(paths[0]).peek()
    small = dict(num_pdfs=P, hidden_dim=32, bottleneck_dim=8, num_layers=2)
    jcfg, tcfg = JCfg(**small), TdnnfConfig(**small)
    params, stats = _jax_init(jcfg, np.zeros((2, 24, feat_dim), np.float32))
    den = auto_den_graph(compile_den_graph(_load_any_fst(den_path)[0], P), device="cpu")
    ck = str(tmp_path / "ck")
    _port_checkpoint(ck, tcfg, feat_dim, params, stats, den)
    got = cp_main([*common, "--device", "cpu", "--checkpoint-dir", ck])
    assert got["restored"] and not want["restored"]
    assert got["frames"] == want["frames"] == 2 * 3 * 6
    for k in ("objf", "l2_term", "xent_objf"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)


def test_export_posteriors_matches_the_jax_tool(tmp_path):
    from torchain_tpu.cli.export_posteriors import main as j_export_main
    from torchain_tpu.models import TdnnfConfig as JCfg
    from torchain_tpu_torch.data import synthetic_dataset
    from torchain_tpu_torch.io import read_ark_text
    from torchain_tpu_torch.models import TdnnfConfig
    from torchain_tpu_torch.ops import auto_den_graph

    args = ["--synthetic", "--num-utts", "4", "--num-phones", "4", "--feat-dim", "8", *SMALL]
    jpath, tpath = str(tmp_path / "j.ark"), str(tmp_path / "t.ark")
    assert j_export_main([*args, "--out", jpath]) == 0

    corpus = synthetic_dataset(num_utts=4, num_phones=4, feat_dim=8, seed=0)
    small = dict(num_pdfs=corpus.tree.num_pdfs, hidden_dim=32, bottleneck_dim=8, num_layers=2)
    jcfg, tcfg = JCfg(**small), TdnnfConfig(**small)
    left, right = tcfg.context
    params, stats = _jax_init(jcfg, np.zeros((1, 60 + left + right, 8), np.float32))
    ck = str(tmp_path / "ck")
    _port_checkpoint(ck, tcfg, 8, params, stats,
                     auto_den_graph(corpus.den_graph, device="cpu"))
    assert export_main([*args, "--device", "cpu", "--checkpoint-dir", ck, "--out", tpath]) == 0
    want, got = read_ark_text(jpath), read_ark_text(tpath)
    assert list(got) == list(want) == [f"utt{i}" for i in range(4)]
    for k in want:
        assert got[k].shape == want[k].shape
        np.testing.assert_allclose(got[k], want[k], atol=1e-5, err_msg=k)


def test_export_posteriors_keeps_the_synthetic_only_contract(tmp_path, capsys):
    assert export_main(["--out", str(tmp_path / "x.ark"), "--device", "cpu"]) == 2
    assert "only --synthetic" in capsys.readouterr().err


@pytest.mark.skipif(torch.cuda.is_available(), reason="holds the refusal where there is no card")
def test_each_cli_exits_2_without_a_card_unless_asked_for_the_cpu(tmp_path, capsys):
    paths, den_path, _tree, _g = _kaldi_prep(tmp_path, n_archives=1, records_per=1)
    runs = [
        lambda: train_main(["--synthetic", "--steps", "1", *SMALL]),
        lambda: train_main(["--cegs", paths[0], "--den-fst", den_path, *SMALL]),
        lambda: cp_main(["--cegs", paths[0], "--den-fst", den_path, *SMALL]),
        lambda: export_main(["--synthetic", "--out", str(tmp_path / "p.ark"), *SMALL]),
    ]
    for run in runs:
        with pytest.raises(SystemExit) as e:
            run()
        assert e.value.code == 2
        assert "no CUDA device" in capsys.readouterr().err
    assert not (tmp_path / "p.ark").exists()
