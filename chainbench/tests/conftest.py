"""Tiny cells for the CPU tests: the benchmark's own configuration and
traffic files with every size cut down, run by the same Session on the CPU
(the program's steps eager, float32: `capture` false)."""

from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(HERE.parent))

from chainbench.spec import Cell  # noqa: E402

CORPUS = dict(corpus_seed=5, num_phones=6, utterance_frames_out=30, num_utterances=12, lm_extra_states=20)
#: the TDNN-F's bottleneck-to-input ratio near the cell's (160 / 3072): the
#: semi-orthogonal constraint then works where the cell's does, at
#: tr(P P) rows / tr(P)^2 between 1.02 and 1.1 (chainbench/reference/optim.py)
TDNNF = dict(hidden_dim=128, bottleneck_dim=12, prefinal_dim=16)
#: the cell's own limits: the tiny float32 runs must pass them, the faults fail them
LIMITS_OF = {"tdnnf": "tdnnf_ls.b128_t50", "conformer": "conformer_m.b64_t150"}


def tiny_cell(kind: str, limits: dict | None = None) -> Cell:
    if kind == "tdnnf":
        cfg = json.loads((HERE / "configs" / "tdnnf_librispeech.json").read_text())
        cfg["model"]["kwargs"].update(TDNNF, num_layers=5, dtype="float32")
        cfg["reference"].update(TDNNF, layers=[[1, 1], [1, 1], [1, 1], [1, 3], [1, 1]])
        traffic = json.loads((HERE / "traffic" / "b128_t50.json").read_text())
    else:
        cfg = json.loads((HERE / "configs" / "conformer_m.json").read_text())
        kw = dict(dim=16, num_layers=2, num_heads=2, conv_kernel=5, prefinal_dim=8)
        cfg["model"]["kwargs"].update(kw, dtype="float32")
        cfg["reference"].update(kw)
        traffic = json.loads((HERE / "traffic" / "b64_t150.json").read_text())
    cfg["corpus"].update(CORPUS, feat_dim=12)
    if "ivector_dim" in cfg["corpus"]:
        cfg["corpus"]["ivector_dim"] = 4
    traffic.update(batch_size=4, chunk_frames_out=10, warmup_steps=5, capture=False)
    if limits is None:
        limits = json.loads((HERE / "limits" / f"{LIMITS_OF[kind]}.json").read_text())
    return Cell(f"tiny_{kind}", cfg, traffic, limits, 1, [], [])


@pytest.fixture
def tiny():
    return tiny_cell
