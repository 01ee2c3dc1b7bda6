"""On the card, at each cell's own size: the program's first steps pass the
cell's limits against the reference, and the control (the reference with
float8 products in the program's place) and each planted fault fail them
(the semi-orthogonal constraint left out where the trunk has one).
Skips where there is no card; run there with

    python -m pytest chainbench/tests/test_bench_card.py -q
"""

from __future__ import annotations

import json

import pytest
import torch

from chainbench import check
from chainbench.session import Session
from chainbench.spec import ROOT, load_cell

pytestmark = pytest.mark.cuda

WORKLOADS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the cells run on the card only)")


@pytest.mark.parametrize("workload", WORKLOADS)
def test_the_control_and_the_faults_fail_where_the_program_passes(card, workload):
    cell = load_cell(workload)
    s = Session(cell, 4_000_000_001 + WORKLOADS.index(workload), workers=8)
    s.setup()
    s.release()
    ref = s.reference()
    ok, checks = check.verdict(check.numbers(s.program_readings, ref), cell.limits)
    assert ok, checks
    faults = [("float8", None), ("float32", "half"), ("float32", "double"),
              ("float32", "unchanged")]
    if "ortho_in" in ref:
        faults.append(("float32", "unconstrained"))
    for precision, fault in faults:
        other = s.reference(precision, fault)
        ok, checks = check.verdict(check.numbers(other, ref), cell.limits)
        assert not ok, (precision, fault, checks)
