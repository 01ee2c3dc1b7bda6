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


# -- the raw-audio front and the egs cache -----------------------------------
#
# A raw-audio data dir (data/synth_wav.py, tests/test_wav_corpus.py's
# fixture) through `cli.train --wav-dir --cmvn speaker --speed-perturb
# --ivector-dim 3 --ivector-gauss 8` on both packages.  The port's model
# starts from the JAX CLI's init (PRNGKey(0), convert.params_from_jax, put
# in place of the port's seeded draw), so the two runs compute the same
# function of features that differ by the filterbank's float32 rounding
# (tests/test_torch_features.py) and of i-vectors trained on them in
# float64: the run's mean objf is held at WAV_RTOL = 1e-3 (the float32
# trunk's card-against-CPU gate).

WAV_RTOL = 1e-3
WAV_FIXTURE = dict(num_utts=8, vocab_size=6, num_phones=4, num_speakers=2, seed=0)
WAV_ARGS = ["--cmvn", "speaker", "--speed-perturb", "--ivector-dim", "3", "--ivector-gauss",
            "8", "--model", "tdnnf", *SMALL, "--chunk-frames", "8", "--batch-size", "4",
            "--seed", "0"]


@pytest.fixture(scope="module")
def wav_dir(tmp_path_factory):
    from torchain_tpu_torch.data import make_wav_data_dir

    d = tmp_path_factory.mktemp("wavdir")
    make_wav_data_dir(str(d), **WAV_FIXTURE)
    return str(d)


def _from_jax_init(monkeypatch):
    """Make the port CLI's `_build_model` load the JAX CLI's init."""
    from torchain_tpu.models import TdnnfConfig as JCfg
    from torchain_tpu_torch.cli import train as cli_train
    from torchain_tpu_torch.convert import params_from_jax

    build = cli_train._build_model

    def built(args, num_pdfs, feat_dim, device):
        model, cfg = build(args, num_pdfs, feat_dim, device)
        jcfg = JCfg(num_pdfs=num_pdfs, hidden_dim=args.hidden_dim,
                    bottleneck_dim=args.bottleneck_dim, num_layers=args.num_layers)
        params, stats = _jax_init(jcfg, np.zeros((2, 24, feat_dim), np.float32))
        model.load_state_dict(params_from_jax(params, stats, cfg))
        return model, cfg

    monkeypatch.setattr(cli_train, "_build_model", built)


def test_train_cli_from_raw_audio_matches_the_jax_cli(tmp_path, wav_dir, monkeypatch):
    from torchain_tpu.cli.train import main as j_train_main

    common = ["--wav-dir", wav_dir, *WAV_ARGS, "--epochs", "2"]
    want = j_train_main(common)
    _from_jax_init(monkeypatch)
    out = str(tmp_path / "m.jsonl")
    got = train_main([*common, "--device", "cpu", "--log-every", "1", "--metrics-out", out])
    assert got["steps"] == want["steps"] >= 4
    np.testing.assert_allclose(got["objf"], want["objf"], rtol=WAV_RTOL)
    lines = _metrics(out)
    assert all(set(m) == JAX_METRIC_KEYS for m in lines)
    stages = got["timings"]["stages_s"]
    assert {"wav_read_s", "speed_perturb_s", "fbank_s", "cmvn_s", "graph_s", "ivector_s",
            "train_s"} <= set(stages)


def test_saved_egs_train_to_the_same_losses_bit_for_bit(tmp_path, wav_dir, monkeypatch):
    from torchain_tpu_torch.data import loader

    egs = str(tmp_path / "egs.npz")
    base = ["--wav-dir", wav_dir, *WAV_ARGS, "--epochs", "2", "--device", "cpu",
            "--log-every", "1"]
    first = train_main([*base, "--precompile-egs", "2", "--save-egs", egs,
                        "--metrics-out", str(tmp_path / "a.jsonl")])
    assert first["egs"]["precompiled"] == first["egs"]["saved"] > 0
    assert first["egs"]["save_bytes"] > 0
    compiled = []
    orig = loader.ChainDataset._chunk_supervision

    def counting(self, *a, **k):
        compiled.append(1)
        return orig(self, *a, **k)

    monkeypatch.setattr(loader.ChainDataset, "_chunk_supervision", counting)
    second = train_main([*base, "--load-egs", egs, "--metrics-out", str(tmp_path / "b.jsonl")])
    assert not compiled  # every supervision came from the archive
    assert second["egs"]["loaded"] == first["egs"]["saved"]
    a, b = _metrics(tmp_path / "a.jsonl"), _metrics(tmp_path / "b.jsonl")
    keys = JAX_METRIC_KEYS - {"wall_s", "frames_per_s"}
    assert [{k: m[k] for k in keys} for m in a] == [{k: m[k] for k in keys} for m in b]


@pytest.mark.parametrize("where", ["ram", "device"])
def test_materialized_egs_give_the_live_runs_losses(tmp_path, wav_dir, where):
    """With --lr 0 and no semi-orthogonal constraint the model stays put,
    so each step's loss is a function of its batch alone: a materialized
    epoch (--materialize-egs; "device" on --device cpu here) replays the
    live epoch's batches in another order, and the losses agree as a
    multiset, bit for bit."""
    base = ["--wav-dir", wav_dir, *WAV_ARGS, "--epochs", "1", "--device", "cpu",
            "--log-every", "1", "--lr", "0", "--semi-ortho-every", "0"]
    runs = {}
    for name, extra in (("live", []), ("mat", ["--materialize-egs", where])):
        out = str(tmp_path / f"{name}.jsonl")
        res = train_main([*base, *extra, "--metrics-out", out])
        runs[name] = sorted(m["loss"] for m in _metrics(out))
    assert res["egs"]["materialized"] == len(runs["mat"]) >= 3
    assert res["egs"]["materialized_bytes"] > 0
    assert runs["mat"] == runs["live"]
    with pytest.raises(SystemExit, match="frame-shift"):
        train_main([*base, "--materialize-egs", where, "--frame-shift-cycle"])


def test_egs_get_from_raw_audio_writes_the_jax_tools_archive(tmp_path, wav_dir):
    from torchain_tpu.cli.egs import main as j_egs_main
    from torchain_tpu_torch.cli.egs import main as egs_main
    from torchain_tpu_torch.data.cegs import iter_cegs_ark

    args = ["--wav-dir", wav_dir, "--batch-size", "4", "--chunk-frames", "8",
            "--left-context", "2", "--right-context", "4"]
    jpath, tpath = str(tmp_path / "j.ark"), str(tmp_path / "t.ark")
    assert j_egs_main(["get", jpath, *args]) == 0
    assert egs_main(["get", tpath, *args, "--device", "cpu"]) == 0
    want, got = list(iter_cegs_ark(jpath)), list(iter_cegs_ark(tpath))
    assert [k for k, _ in got] == [k for k, _ in want] and len(got) >= 2
    for (_, a), (_, b) in zip(got, want):
        sa, sb = a.outputs[0].supervision, b.outputs[0].supervision
        for f in ("weight", "num_sequences", "frames_per_sequence", "label_dim"):
            assert getattr(sa, f) == getattr(sb, f), f
        assert list(sa.fst.all_arcs()) == list(sb.fst.all_arcs())
        assert [sa.fst.final(s) for s in range(sa.fst.num_states)] == [
            sb.fst.final(s) for s in range(sb.fst.num_states)]
        fa, fb = a.io("input").features, b.io("input").features
        assert fa.shape == fb.shape
        # speaker CMVN of log-mel values within the filterbank's gate
        from tests.test_torch_features import TONE_ATOL

        np.testing.assert_allclose(fa, fb, rtol=0, atol=2 * TONE_ATOL)


def test_the_port_takes_every_flag_of_the_jax_train_cli():
    """An argparse comparison of the two train CLIs: every JAX flag and
    choice is in the port, with the JAX default (--model-parallel too);
    every --model and --optimizer choice is there; the port adds --device
    and --log-every.  `cli.compute_prob` takes every --model choice of the
    JAX tool.  `cli.egs get` lacks nothing (and adds --device)."""
    from torchain_tpu.cli.train import build_argparser as j_parser
    from torchain_tpu_torch.cli.train import build_argparser

    def flags(p):
        return {s: a for a in p._actions for s in a.option_strings}

    j, t = flags(j_parser()), flags(build_argparser())
    assert not set(j) - set(t)
    assert set(t) - set(j) == {"--device", "--log-every"}
    for name in set(j) & set(t) - {"--model", "--optimizer", "--help", "-h"}:
        assert j[name].choices == t[name].choices, name
        assert j[name].default == t[name].default or name == "--log-every", name
    for name in ("--model", "--optimizer"):
        assert set(j[name].choices) == set(t[name].choices), name
        assert j[name].default == t[name].default, name
    from torchain_tpu.cli.compute_prob import build_argparser as j_cp
    from torchain_tpu_torch.cli.compute_prob import build_argparser as t_cp

    assert set(flags(j_cp())["--model"].choices) == set(flags(t_cp())["--model"].choices)

    import torchain_tpu.cli.egs as jegs
    import torchain_tpu_torch.cli.egs as tegs

    def get_flags(mod):
        seen = {}

        class Stop(Exception):
            pass

        def grab(self, args=None, namespace=None):
            sub = next(a for a in self._actions if hasattr(a, "choices")
                       and isinstance(a.choices, dict))
            seen.update(flags(sub.choices["get"]))
            raise Stop

        import argparse

        orig = argparse.ArgumentParser.parse_args
        argparse.ArgumentParser.parse_args = grab
        try:
            mod.main(["get", "x"])
        except Stop:
            pass
        finally:
            argparse.ArgumentParser.parse_args = orig
        return seen

    jg, tg = get_flags(jegs), get_flags(tegs)
    assert set(tg) - set(jg) == {"--device"} and not set(jg) - set(tg)


def _two_ranks(argv, timeout=240):
    """`cli.train argv` under `torch.distributed.run --standalone
    --nproc-per-node 2`; returns (exit code, output), the launcher killed at
    the timeout."""
    import os
    import subprocess
    import sys

    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
           "2", "-m", "torchain_tpu_torch.cli.train", *argv]
    env = {**os.environ, "OMP_NUM_THREADS": "2"}
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            env=env)
    try:
        out, _ = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    return proc.returncode, out


def test_train_cli_on_two_gloo_ranks_is_the_one_process_run(tmp_path):
    """`cli.train --distributed --data-parallel 2` under `torch.distributed.run
    --standalone --nproc-per-node 2` (gloo on the CPU, each rank half of
    every global batch) trains the one-process run's curve: loss, objf and
    gradient norm rel 1e-5 a step.  Without a process group --data-parallel
    2 and --model-parallel 2 exit with the mesh's error."""
    argv = ["--synthetic", "--device", "cpu", "--steps", "3", "--log-every", "1", *SMALL]
    two, one = str(tmp_path / "two.jsonl"), str(tmp_path / "one.jsonl")
    rc, out = _two_ranks([*argv, "--distributed", "--data-parallel", "2", "--metrics-out", two])
    assert rc == 0, out[-3000:]
    assert out.count("[distributed] rank") == 2
    train_main([*argv, "--metrics-out", one])
    a, b = _metrics(two), _metrics(one)
    assert len(a) == len(b) == 3
    for x, y in zip(a, b):
        for k in ("loss", "objf", "grad_norm", "weight"):
            assert x[k] == pytest.approx(y[k], rel=1e-5), (k, x, y)
    with pytest.raises(SystemExit, match="mesh 2x1 != 1 devices"):
        train_main([*argv, "--data-parallel", "2"])
    with pytest.raises(SystemExit, match="mesh 0x2 != 1 devices"):
        train_main([*argv, "--model-parallel", "2"])


def test_train_cli_model_parallel_on_two_gloo_ranks_is_the_one_process_run(tmp_path):
    """`cli.train --distributed --model-parallel 2` on two gloo ranks: a data
    axis of 1, both ranks on the whole of every batch with the state
    replicated (the JAX Trainer's model axis), the one-process run's
    curve (loss, objf, gradient norm rel 1e-5 a step) written once, by
    global rank 0, with its checkpoint."""
    argv = ["--synthetic", "--device", "cpu", "--steps", "3", "--log-every", "1", *SMALL]
    two, one = str(tmp_path / "two.jsonl"), str(tmp_path / "one.jsonl")
    ck = tmp_path / "ck"
    rc, out = _two_ranks([*argv, "--distributed", "--model-parallel", "2", "--metrics-out", two,
                          "--checkpoint-dir", str(ck)])
    assert rc == 0, out[-3000:]
    assert out.count("[distributed] rank") == 2
    ends = [json.loads(ln) for ln in out.splitlines() if ln.startswith('{"objf"')]
    assert len(ends) == 2 and ends[0]["steps"] == ends[1]["steps"] == 3
    train_main([*argv, "--metrics-out", one])
    a, b = _metrics(two), _metrics(one)
    assert len(a) == len(b) == 3
    for x, y in zip(a, b):
        for k in ("loss", "objf", "grad_norm", "weight"):
            assert x[k] == pytest.approx(y[k], rel=1e-5), (k, x, y)
    assert sorted(p.name for p in ck.iterdir() if p.name.isdigit()) == ["3"]


def test_train_cli_e2e_on_two_gloo_ranks_stops_every_rank_together():
    """Flat-start e2e under two ranks: each rank batches its own utterances
    (every second one) at half the global batch, and both stop at the
    first rank's last batch of the epoch."""
    rc, out = _two_ranks(["--synthetic", "--e2e", "--device", "cpu", "--distributed",
                          "--epochs", "1", "--batch-size", "4", "--log-every", "1", *SMALL])
    assert rc == 0, out[-3000:]
    ends = [json.loads(ln) for ln in out.splitlines() if ln.startswith('{"objf"')]
    assert len(ends) == 2 and ends[0]["steps"] == ends[1]["steps"] > 0
    assert ends[0]["objf"] == ends[1]["objf"]
