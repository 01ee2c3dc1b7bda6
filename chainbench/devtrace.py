"""The device trace of a few steps: torch.profiler over the window, read
back from its Chrome trace.

Busy time is the union of the device's kernel, copy and fill intervals
inside the window (a side stream's work beside the step's counts once);
kernel time and launches are summed by name.  The repository's
chip_smoke.py `_trace` summed kernel times on one stream; this copy takes
the union, and the readers check each of the program's kernels' launch
count against steps x launches a step, since the profiler has been seen to
drop events.  The idle gaps are named by what the host was doing at their
middle: the innermost host operation running then.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import tempfile
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
WINDOW = "chainbench.window"


@dataclasses.dataclass
class Trace:
    steps: int
    window_s: float
    busy_s: float
    #: device op name -> [launches, seconds]
    ops: dict
    #: host activity -> seconds of device idle while it ran
    gaps: dict

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.ops.items(), key=lambda kv: -kv[1][1])[:top]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:top]
        return dict(device_ops=[[n[:120], s] for n, (_, s) in ops],
                    idle_gaps=[[n[:120], s] for n, s in gaps])

    def matching(self, patterns) -> tuple:
        """(launches, seconds) of the device ops whose name holds any of
        `patterns`."""
        n = s = 0
        for name, (c, t) in self.ops.items():
            if any(p in name for p in patterns):
                n += c
                s += t
        return n, s


def profile(run, steps: int) -> Trace:
    """Trace `run()`, which makes `steps` steps, inside a span named
    `WINDOW`."""
    import torch
    from torch.profiler import ProfilerActivity, record_function
    from torch.profiler import profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            run()
            torch.cuda.synchronize()
    tmp = tempfile.mkdtemp()
    try:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return summarize(events, steps)


def summarize(events: list, steps: int) -> Trace:
    """The Trace of Chrome-trace `events` (microsecond ts and dur)."""
    win = [e for e in events if e.get("ph") == "X" and e.get("name") == WINDOW
           and e.get("cat") == "user_annotation"]
    if not win:
        raise RuntimeError(f"the trace holds no {WINDOW} span")
    w0 = min(e["ts"] for e in win)
    w1 = max(e["ts"] + e["dur"] for e in win)
    dev = sorted((e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS
                  and e["ts"] < w1 and e["ts"] + e["dur"] > w0), key=lambda e: e["ts"])
    if not any(e["cat"] == "kernel" for e in dev):
        raise RuntimeError("the profiler recorded no device kernels")
    ops: dict = defaultdict(lambda: [0, 0.0])
    merged: list = []
    for e in dev:
        a, b = max(e["ts"], w0), min(e["ts"] + e["dur"], w1)
        ops[e["name"]][0] += 1
        ops[e["name"]][1] += (b - a) * 1e-6
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy = sum(b - a for a, b in merged)
    host = sorted((e for e in events if e.get("ph") == "X" and e.get("cat") in HOST_CATS
                   and e.get("name") != WINDOW), key=lambda e: e["ts"])
    gaps: dict = defaultdict(float)
    edges = [w0] + [x for ab in merged for x in ab] + [w1]
    active: list = []
    i = 0
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        t = (a + b) / 2
        while i < len(host) and host[i]["ts"] <= t:
            active.append(host[i])
            i += 1
        active = [e for e in active if e["ts"] + e["dur"] >= t]
        # the innermost (shortest) host operation running at the gap's middle
        name = min(active, key=lambda e: e["dur"])["name"] if active else "host idle"
        gaps[name] += (b - a) * 1e-6
    return Trace(steps, (w1 - w0) * 1e-6, busy * 1e-6, dict(ops), dict(gaps))
