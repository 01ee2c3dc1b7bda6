"""The harness end to end on the CPU at tiny sizes: a sound run of the
program passes the cells' limits against the reference, and a run with the
timed path broken underneath fails them, once for each fault a training
cell can have (one card: no exchange between cards to leave out; a
training step's answers are its losses and its update, so the altered
answer is one parameter's update doubled)."""

from __future__ import annotations

import dataclasses
import shutil
import subprocess
import sys

import pytest
import torch

from chainbench.session import Session
from chainbench.spec import ROOT
from torchain_tpu_torch.train import chain_tx, step, trainer


def _run(cell, seed=2**31 + 11):
    s = Session(cell, seed, device="cpu", workers=2)
    s.setup()
    w = s.window(0.3)
    assert w["steps"] >= 1 and w["window_s"] >= 0.3
    s.release()
    return s.compare(s.reference())


@pytest.mark.parametrize("kind", ["tdnnf", "conformer"])
def test_a_sound_run_is_correct(tiny, kind):
    correct, checks = _run(tiny(kind))
    assert correct, checks


def _half_batch(loss_fn):
    def broken(y, x, den, sup, opts, mesh=None):
        w = sup.weight.clone()
        w[w.shape[0] // 2:] = 0.0
        return loss_fn(y, x, den, dataclasses.replace(sup, weight=w), opts, mesh=mesh)
    return broken


def _double(apply):
    def broken(self, kind, scale=1.0):
        p = self.params[0]
        before = p.detach().clone()
        apply(self, kind, scale)
        with torch.no_grad():
            p.add_(p - before)
    return broken


@pytest.mark.parametrize("fault", ["unchanged", "half", "double", "unconstrained"])
def test_a_broken_step_is_not_correct(tiny, monkeypatch, fault):
    """A state left unchanged, half of each batch left out (the mean over
    the rest), one parameter moved by twice its update, the semi-orthogonal
    constraint left out."""
    opt = chain_tx.ChainOptimizer
    if fault == "unconstrained":
        monkeypatch.setattr(trainer, "constrain_semi_orthogonal", lambda model, nu=0.25: 0)
    elif fault == "unchanged":
        monkeypatch.setattr(opt, "apply", lambda self, kind, scale=1.0: None)
    elif fault == "double":
        monkeypatch.setattr(opt, "apply", _double(opt.apply))
    else:
        monkeypatch.setattr(step, "chain_loss", _half_batch(step.chain_loss))
    correct, checks = _run(tiny("tdnnf"))
    assert not correct, checks


def test_no_result_from_the_benchmark_alone(tmp_path):
    """A directory that holds only BENCHMARK.json and the benchmark's folder:
    the run exits non-zero and prints no result (here for want of a card;
    on the card for want of the program)."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "chainbench", tmp_path / "chainbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "chainbench/run.py", "--workload",
                          "tdnnf_ls.b128_t50", "--seed", "5000000000", "--seconds", "1",
                          "--trace", "0"], cwd=tmp_path, capture_output=True, text=True)
    assert out.returncode != 0 and out.stdout == ""
