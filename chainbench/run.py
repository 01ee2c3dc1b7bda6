"""Run one cell of the benchmark once:

    python3 chainbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the card(s) the cell asks
for.  Set-up (kernels, corpus, graphs, egs, model, the captured steps and
their first readings) is timed from process start; then the window trains
for `--seconds` through `Trainer.fit`.  With `--trace 0` the result holds
the cell's end-to-end metrics, with `--trace 1` its per-layer metrics (the
window again, then a traced window of `trace_steps` steps).  Last, the
program's state is freed and the reference follows the first steps: the
comparison decides `correct`.

The last line of standard output is the result (one JSON object); the last
lines of standard error are the numbers compared, each beside its limit.
Exits 2 without a result where the card is missing, and 3 where a module of
the JAX package or JAX itself was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# run as a script: the checkout's root, not this folder, is the import root
sys.path[:] = [str(ROOT)] + [p for p in sys.path if Path(p or ".").resolve() != ROOT / "chainbench"]

#: top-level module names that may not be loaded (compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "torchain_tpu")
#: kernel and build caches of the program and its libraries, at fixed paths
#: inside the checkout
CACHE = ROOT / ".chainbench_cache"


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def interval_summary(ints: list, first_step: int) -> dict:
    """Quantiles of the step intervals, and where the slow ones fall: how
    many of the intervals over 1.05x the median follow a step whose number
    is a multiple of 20 (the Trainer reads its metrics back then) or of 4
    (the semi-orthogonal constraint)."""
    if len(ints) < 40:
        return {}
    q = statistics.quantiles(ints, n=40)
    med = statistics.median(ints)
    slow = [first_step + i for i, v in enumerate(ints) if v > 1.05 * med]
    return dict(mean=statistics.fmean(ints), p50=med, p90=q[35], p95=q[37], p975=q[38],
                max=max(ints), slow=len(slow), slow_after_20=sum(s % 20 == 0 for s in slow),
                slow_after_4=sum(s % 4 == 0 for s in slow),
                slow_excess_ms=sum(v - med for v in ints if v > 1.05 * med))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")

    from chainbench.spec import load_cell, reader

    cell = load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"chainbench: {args.workload} needs {cell.chips} CUDA device(s);"
            f" this machine has {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    import torchain_tpu_torch  # noqa: F401
    from chainbench.session import Session

    t_import = time.perf_counter() - T_START
    tr = cell.traffic
    s = Session(cell, args.seed, workers=min(8, os.cpu_count() or 1))
    torch.cuda.reset_peak_memory_stats()
    s.setup()
    setup_s = time.perf_counter() - T_START
    log("setup_s " + json.dumps(dict(import_s=t_import, **s.phases, total_s=setup_s)))
    log(f"sizes: den {type(s.den_device).__name__} S {s.corpus.den.num_states} arcs"
        f" {s.corpus.den.num_arcs}; sup caps {s.feed.estimate_sup_caps()} L_cap"
        f" {s.feed.estimate_live_arcs()}")

    win = s.window(args.seconds)
    bad = forbidden_modules()
    if bad:
        log(f"chainbench: loaded {bad}, which the port may not load")
        return 3
    peak = torch.cuda.max_memory_allocated()
    # an output frame is frame_subsampling_factor input frames of audio
    frame_s = cell.config["frame_shift_s"] * s.corpus.fsf
    audio = win["steps"] * s.B * s.T * frame_s
    ints = win["intervals_ms"]
    log(f"window: {win['steps']} steps in {win['window_s']:.4f} s; {len(ints)} step"
        f" intervals, median {statistics.median(ints) if ints else float('nan'):.4f} ms;"
        f" host ms between steps {win['host_ms']}; card {power_limit()}")
    log("intervals " + json.dumps(interval_summary(ints, win["first_step"])))
    device = dict(platform="gpu", kind=torch.cuda.get_device_name(0), count=cell.chips,
                  memory_peak_bytes=int(peak))
    result = dict(correct=False, attempted=win["steps"] * s.B, failed=int(win["failed"]))
    if args.trace:
        trace = s.traced(tr["trace_steps"])
        run = dict(session=s, window=win, trace=trace, sizes=s.sizes())
        metrics = {}
        for m in cell.per_layer:
            value = reader(m["name"]).read(run)
            if value is None:
                log(f"per-layer {m['name']}: nothing to read")
                continue
            metrics[m["name"]] = dict(value=float(value), unit=m["unit"])
        device.update(busy_s=trace.busy_s, window_s=trace.window_s)
        result.update(metrics=metrics, device=device, breakdown=trace.breakdown())
    else:
        values = dict(audio_s_per_s=audio / win["window_s"],
                      step_ms_p975=float(statistics.quantiles(ints, n=40)[-1]),
                      setup_s=setup_s)
        metrics = {m["name"]: dict(value=values[m["name"]], unit=m["unit"])
                   for m in cell.end_to_end}
        result.update(metrics=metrics, device=device)

    s.release()
    t0 = time.perf_counter()
    ref = s.reference()
    correct, checks = s.compare(ref)
    log(f"reference: {time.perf_counter() - t0:.2f} s; program loss {s.program_readings['loss']}"
        f" reference loss {ref['loss']}")
    bad = forbidden_modules()
    if bad:
        log(f"chainbench: loaded {bad}, which the port may not load")
        return 3
    result["correct"] = correct
    result["checks"] = checks
    for name, c in checks.items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
