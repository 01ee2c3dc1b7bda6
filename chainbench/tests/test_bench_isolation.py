"""What the harness loads, in a fresh interpreter: no JAX and no module of
the JAX package (top-level names compared whole: the port's name begins
with the JAX package's), and the reference and corpus nothing of the
program either."""

from __future__ import annotations

import json
import subprocess
import sys

from chainbench.spec import HERE, ROOT

HARNESS = ["chainbench.run", "chainbench.session", "chainbench.control", "chainbench.program",
           "chainbench.devtrace", "chainbench.check", "chainbench.weights", "chainbench.spec",
           "chainbench.rooflines", "chainbench.rooflines.tdnnf", "chainbench.rooflines.conformer",
           "chainbench.placements.materialized_device"]
REFERENCE = ["chainbench.reference", "chainbench.reference.chain",
             "chainbench.reference.lattice", "chainbench.reference.ops",
             "chainbench.reference.optim", "chainbench.reference.optimizers.adam",
             "chainbench.reference.tdnnf",
             "chainbench.reference.conformer", "chainbench.reference.train",
             "chainbench.corpus"]


def _top_level(modules, readers=()) -> set:
    code = (
        "import importlib, json, sys\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "from chainbench.spec import reader\n"
        f"for r in {list(readers)!r}: reader(r)\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, env={"PATH": "/usr/bin:/bin"})
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_harness_loads_no_jax():
    readers = [p.stem for p in (HERE / "metrics").glob("*.py")]
    assert readers
    top = _top_level(HARNESS + REFERENCE, readers)
    assert "torchain_tpu_torch" in top and "torch" in top
    assert not top & {"jax", "jaxlib", "flax", "torchain_tpu"}


def test_the_reference_loads_nothing_of_the_program():
    top = _top_level(REFERENCE)
    assert "torch" in top
    assert not top & {"jax", "jaxlib", "flax", "torchain_tpu", "torchain_tpu_torch"}
