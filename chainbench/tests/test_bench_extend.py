"""A configuration, a traffic mix, a placement and a per-layer metric are
new files and entries only: a copy of the benchmark in a temporary
directory gains a dummy of each (a mix with eager steps, `capture` false,
whose batches stay in host memory, `cli.train --materialize-egs ram`), and
the harness finds them by name."""

from __future__ import annotations

import json
import shutil

from chainbench.session import Session
from chainbench.spec import HERE, ROOT, load_cell, reader

READER = '''"""A dummy per-layer metric: the window's steps."""

LAYER = "Trainer"
UNIT = "steps"
MOVES = "audio_s_per_s"


def read(run):
    return run["window"]["steps"]
'''

PLACEMENT = '''"""A dummy placement: the batches made once and kept in host memory."""

from chainbench import program


def feed(dataset, batch_size, device):
    return program.Feed(program.MaterializedBatches(program.InOrder(dataset), batch_size,
                                                    device=False), batch_size)
'''


def test_a_new_cell_is_files_and_entries(tmp_path, tiny):
    root = tmp_path / "checkout"
    here = root / "chainbench"
    shutil.copytree(HERE, here, ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", root)
    small = tiny("tdnnf")
    (here / "configs" / "dummy_model.json").write_text(json.dumps(small.config))
    mix = dict(small.traffic, placement="dummy_ram", capture=False)
    (here / "traffic" / "dummy_mix.json").write_text(json.dumps(mix))
    (here / "placements" / "dummy_ram.py").write_text(PLACEMENT)
    (here / "limits" / "dummy_model.dummy_mix.json").write_text(json.dumps(small.limits))
    (here / "metrics" / "dummy.steps.py").write_text(READER)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(name="dummy_model", source="https://example.org/dummy",
                                 file="chainbench/configs/dummy_model.json", reduced=[],
                                 why="a test's dummy"))
    bench["workloads"].append(dict(name="dummy_model.dummy_mix", config="dummy_model",
                                   traffic="dummy_mix", chips=1, why="a test's dummy"))
    bench["per_layer"].append(dict(name="dummy.steps", unit="steps", better="higher",
                                   source="program_counter", layer="Trainer",
                                   moves="audio_s_per_s", workloads=["dummy_model.dummy_mix"]))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = load_cell("dummy_model.dummy_mix", root=root, here=here)
    assert cell.config == small.config and cell.traffic == mix
    assert [m["name"] for m in cell.per_layer][-1] == "dummy.steps"
    assert "attention.k7_roofline" not in [m["name"] for m in cell.per_layer]
    metric = reader("dummy.steps", here=here)
    assert (metric.LAYER, metric.UNIT, metric.MOVES) == ("Trainer", "steps", "audio_s_per_s")

    s = Session(cell, 77, device="cpu", workers=2)
    s.setup()
    assert str(s.feed.placed[0].feats.device) == "cpu" and not s.trainer.cfg.capture
    window = s.window(0.2)
    assert metric.read(dict(session=s, window=window)) == window["steps"] >= 1
    s.release()
    assert s.compare(s.reference())[0]


def test_every_metric_file_matches_its_entry():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    files = {p.stem for p in (HERE / "metrics").glob("*.py")}
    assert files == {m["name"] for m in bench["per_layer"]}
    for m in bench["per_layer"]:
        mod = reader(m["name"])
        assert (mod.LAYER, mod.UNIT, mod.MOVES) == (m["layer"], m["unit"], m["moves"])
