"""The comparison's numbers on made-up readings: the worst parameter against
the larger of its own and the median's norm, the entries with a gradient
nought to rounding left out of the change, a state left unchanged reading 1,
the semi-orthogonal constraint's step held to Kaldi's, and a missing limit
or number failing."""

from __future__ import annotations

import math

import torch

from chainbench.check import numbers, verdict
from chainbench.reference.optim import constrain, constrain_kernel


def _t(*x):
    return torch.tensor(x)


REF = dict(loss=[2.0, 1.5, 1.25],
           grad1_vec={"a": _t(1.0, 0.0), "b": _t(0.0, 2.0), "c": _t(4.0, 0.0),
                      "still": _t(1e-6, 0.0)},
           change_vec={"a": _t(0.1, 0.0), "b": _t(0.0, 0.2), "c": _t(0.4, 0.0),
                       "still": _t(0.3, 0.0)})


def test_the_worst_leaf_against_the_median():
    prog = dict(loss=[2.002, 1.5, 1.25],
                grad1_vec={"a": _t(1.1, 0.0), "b": _t(2.0, 0.0), "c": _t(4.0, 0.0),
                           "still": _t(0.5, 0.0)},
                # a's second entry has a reference gradient of 0: its move is
                # round-off's and is not counted
                change_vec={"a": _t(0.1, 5.0), "b": _t(0.0, 0.2), "c": _t(0.44, 0.0),
                            "still": _t(0.0, 0.0)})
    n = numbers(prog, REF, where=True)
    assert math.isclose(n["loss1"], 1e-3) and n["loss2"] == n["loss3"] == 0.0
    # "still" has a gap of 0.5 against the median norm 1.5
    assert n["grad1_leaf_at"] == "still"
    assert math.isclose(n["grad1_leaf"], (0.5 - 1e-6) / 1.5, rel_tol=1e-6)
    # b's gradient turned by 90 degrees: the same norm, a difference of
    # sqrt(8) against its own norm 2
    assert n["grad1_diff_at"] == "b"
    assert math.isclose(n["grad1_diff"], math.sqrt(8) / 2, rel_tol=1e-6)
    # the median of 0.1, sqrt(2), 0 and 5e5 over the own norms
    assert math.isclose(n["grad1_diff_med"], (0.1 + math.sqrt(2)) / 2, rel_tol=1e-5)
    # "still" is left out of the change; c's gap is 0.04 of its own 0.4
    assert n["change_leaf_at"] == "c" and math.isclose(n["change_leaf"], 0.1, rel_tol=1e-6)


def test_an_unchanged_state_reads_one():
    prog = dict(REF, change_vec={k: torch.zeros(2) for k in REF["change_vec"]})
    assert numbers(prog, REF)["change_leaf"] == 1.0


def test_a_missing_limit_or_number_fails():
    assert verdict({"x": 0.1, "not_compared": 5.0}, {"x": 0.2}) == (
        True, {"x": {"value": 0.1, "limit": 0.2}})
    assert not verdict({"x": 0.3}, {"x": 0.2})[0]
    assert not verdict({"x": float("nan")}, {"x": 0.2})[0]
    assert not verdict({"x": 0.1}, {})[0]
    assert not verdict({}, {"x": 0.2})[0]


def test_the_constraint_is_kaldis():
    """Kaldi's step keeps M's scale (the update is orthogonal to M) and
    brings M M^T towards a multiple of I; a nearly semi-orthogonal M (ratio
    under 1.02) moves at twice the speed of one between 1.02 and 1.1."""
    g = torch.Generator().manual_seed(0)
    M = torch.randn(16, 512, generator=g) / 512 ** 0.5
    K = constrain(M)
    assert abs(float(torch.sum(M * (K - M)))) < 1e-4 * float(torch.sum(M * M))

    def err(W):
        P = W @ W.T
        a = torch.sum(P * P) / torch.trace(P)
        return float(torch.linalg.norm(P / a - torch.eye(P.shape[0])))

    assert err(K) < 0.6 * err(M)
    assert torch.allclose(constrain(M.T), K.T, atol=1e-6)
    near = torch.linalg.qr(torch.randn(512, 16, generator=g))[0].T.contiguous()
    near = near + 1e-3 * torch.randn(16, 512, generator=g)
    step = constrain(near) - near
    # at ratio ~1: speed 1/8, so the deviation from the scale falls by half
    P = near @ near.T
    a = torch.sum(P * P) / torch.trace(P)
    want = -0.5 / a * (P - a * torch.eye(16)) @ near
    assert torch.allclose(step, want, atol=1e-7)


def test_ortho_step_reads_the_programs_constraint():
    g = torch.Generator().manual_seed(1)
    before = {"k": torch.randn(2, 256, 12, generator=g) / 512 ** 0.5}
    want = {"k": constrain_kernel(before["k"])}
    ref = dict(REF, ortho_in=before, ortho_out=want)
    good = dict(REF, ortho_in=before, ortho_out=want)
    left_out = dict(REF, ortho_in=before, ortho_out=before)
    half = dict(REF, ortho_in=before, ortho_out={"k": (before["k"] + want["k"]) / 2})
    assert numbers(good, ref)["ortho_step"] < 1e-6
    assert math.isclose(numbers(left_out, ref)["ortho_step"], 1.0, rel_tol=1e-6)
    assert math.isclose(numbers(half, ref)["ortho_step"], 0.5, rel_tol=1e-5)
    assert numbers(REF, ref)["ortho_step"] == math.inf
    assert "ortho_step" not in numbers(good, REF)
