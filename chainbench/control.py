"""The readings the limits of the correctness comparison are set from, for
one cell, in one process:

    python3 chainbench/control.py --workload <name> --seeds 1,2,3 \
        [--candidates-seeds 1,2,3] [--program-dtype float32] [--out readings.jsonl]

For each seed: the program's first steps as a run takes them (set-up and
warm-up, no window) against the reference, the lower reading of each
number.  For each seed of `--candidates-seeds` also the control, the
reference computed with float8 products in the program's place (the
precision below the configuration's bfloat16 trunk), and the faults a
training cell can have, planted in the reference in the program's place:
"half" (half of each batch left out, the mean over the rest), "double"
(one parameter moved by twice its update: an answer altered where it is
produced), "unchanged" (the state left as it was; it reads 1 on
`change_leaf`, and its losses are read too) and "unconstrained" (the
semi-orthogonal constraint left out).  `--program-dtype` runs the
program's trunk in another dtype than the configuration's (a witness:
float32 shows how much of a gap is the bfloat16 trunk's round-off).  Each
reading is a JSON line; the benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:] = [str(ROOT)] + [p for p in sys.path if Path(p or ".").resolve() != ROOT / "chainbench"]

CANDIDATES = (("control_float8", "float8", None), ("fault_half", "float32", "half"),
              ("fault_double", "float32", "double"), ("fault_unchanged", "float32", "unchanged"),
              ("fault_unconstrained", "float32", "unconstrained"))


def readings(cell, seed: int, candidates: bool, emit, who: str = "program") -> None:
    from chainbench import check
    from chainbench.session import Session

    t0 = time.perf_counter()
    s = Session(cell, seed, workers=min(8, os.cpu_count() or 1))
    s.setup()
    s.release()
    ref = s.reference()
    emit(dict(seed=seed, who=who, setup_s=time.perf_counter() - t0,
              **check.numbers(s.program_readings, ref, where=True),
              loss=s.program_readings["loss"], ref_loss=ref["loss"]))
    if not candidates:
        return
    for who, precision, fault in CANDIDATES:
        other = s.reference(precision, fault)
        emit(dict(seed=seed, who=who, **check.numbers(other, ref, where=True),
                  loss=other["loss"]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--candidates-seeds", default="")
    ap.add_argument("--program-dtype", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    from chainbench.spec import load_cell

    cell = load_cell(args.workload)
    who = "program"
    if args.program_dtype:
        cell.config["model"]["kwargs"]["dtype"] = args.program_dtype
        who = f"program_{args.program_dtype}"
    out = open(args.out, "a") if args.out else None

    def emit(rec):
        rec["workload"] = args.workload
        line = json.dumps(rec)
        print(line, flush=True)
        if out is not None:
            out.write(line + "\n")
            out.flush()

    cand = {int(x) for x in args.candidates_seeds.split(",") if x}
    try:
        for seed in [int(x) for x in args.seeds.split(",")]:
            readings(cell, seed, seed in cand, emit, who)
    finally:
        if out is not None:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
