"""What a cell is made of, found by name: `BENCHMARK.json` at the root of
the checkout, `chainbench/configs/<config>.json`,
`chainbench/traffic/<traffic>.json`, `chainbench/limits/<workload>.json`
(the limits of the correctness comparison), one reader
`chainbench/metrics/<metric>.py` per per-layer metric, and the way a mix's
batches reach the card, `chainbench/placements/<placement>.py`, named by
the mix's `placement`.  A new cell, mix, placement or metric is new files
and entries; nothing here names one."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    limits: dict
    chips: int
    end_to_end: list
    per_layer: list
    #: the benchmark's folder the cell's files were found in
    here: Path = HERE


def _in(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT, here: Path = HERE) -> Cell:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    try:
        w = next(w for w in bench["workloads"] if w["name"] == name)
    except StopIteration:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json") from None
    limits = here / "limits" / f"{name}.json"
    return Cell(
        name=name,
        config=json.loads((here / "configs" / f"{w['config']}.json").read_text()),
        traffic=json.loads((here / "traffic" / f"{w['traffic']}.json").read_text()),
        limits=json.loads(limits.read_text()) if limits.exists() else {},
        chips=int(w["chips"]),
        end_to_end=[m for m in bench["end_to_end"] if _in(m, name)],
        per_layer=[m for m in bench["per_layer"] if _in(m, name)],
        here=here,
    )


def module(folder: str, name: str, here: Path = HERE):
    """The module `chainbench/<folder>/<name>.py`, loaded from its file."""
    path = here / folder / f"{name}.py"
    if not path.exists():
        raise SystemExit(f"no {path.relative_to(here.parent)}")
    spec = importlib.util.spec_from_file_location(f"chainbench.{folder}.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str, here: Path = HERE):
    """The module `chainbench/metrics/<metric>.py` (its LAYER, UNIT, MOVES
    and read(run) -> number or None)."""
    return module("metrics", metric, here)
