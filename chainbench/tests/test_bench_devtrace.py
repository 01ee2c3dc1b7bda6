"""The trace's reduction on a made-up Chrome trace: busy time is the union
of the device's intervals inside the window, ops are summed by name, and
idle gaps are named by the innermost host operation at their middle."""

from __future__ import annotations

import pytest

from chainbench.devtrace import WINDOW, summarize


def _x(cat, name, ts, dur):
    return dict(ph="X", cat=cat, name=name, ts=ts, dur=dur)


EVENTS = [
    _x("user_annotation", WINDOW, 0, 100),
    _x("gpu_user_annotation", WINDOW, 0, 100),
    _x("kernel", "den_fwd_kernel", 10, 10),
    _x("kernel", "nvjet_tst_128", 15, 15),  # overlaps the first (a side stream)
    _x("gpu_memcpy", "Memcpy DtoD", 50, 10),
    _x("kernel", "den_fwd_kernel", 95, 10),  # runs past the window's end
    _x("cpu_op", "aten::copy_", 25, 30),
    _x("cuda_runtime", "cudaGraphLaunch", 60, 35),
    _x("cpu_op", "fit", 0, 100),
]


def test_busy_is_the_union_inside_the_window():
    t = summarize(EVENTS, steps=2)
    assert t.window_s == pytest.approx(100e-6)
    assert t.busy_s == pytest.approx((20 + 10 + 5) * 1e-6)
    assert t.ops["den_fwd_kernel"] == [2, pytest.approx(15e-6)]
    assert t.matching(("gemm", "nvjet")) == (1, pytest.approx(15e-6))


def test_gaps_are_named_by_the_host():
    t = summarize(EVENTS, steps=2)
    assert t.gaps["fit"] == pytest.approx(10e-6)  # 0..10: only the outer op runs
    assert t.gaps["aten::copy_"] == pytest.approx(20e-6)  # 30..50
    assert t.gaps["cudaGraphLaunch"] == pytest.approx(35e-6)  # 60..95
    b = t.breakdown()
    assert b["idle_gaps"][0][0] == "cudaGraphLaunch"
    assert [n for n, _ in b["device_ops"]][0] in ("den_fwd_kernel", "nvjet_tst_128")


def test_a_trace_without_kernels_is_refused():
    with pytest.raises(RuntimeError):
        summarize(EVENTS[:2], steps=1)
