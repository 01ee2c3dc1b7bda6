"""The port's nnet3 import (torchain_tpu_torch/graphs/nnet3.py) against the
JAX package's, on the JAX test's miniature chain TDNN-F
(tests/test_nnet3.py `_tdnnf_style_nnet`) behind a chain transition model:
the port reads the JAX writer's `final.mdl` and writes it back to the same
bytes, its config lines, descriptors and `describe` are the JAX reader's,
and `Nnet.forward` (NumPy, on the host) gives the same outputs bit for bit
on inputs drawn from a seed.  An unknown component parses and writes back
alike, and refuses to forward in both."""

import io

import numpy as np
import pytest

pytest.importorskip("jax")

from tests.test_nnet3 import _tdnnf_style_nnet
from torchain_tpu.graphs import nnet3 as jnn
from torchain_tpu.graphs.transition_model import chain_transition_model as jchain
from torchain_tpu_torch.graphs import nnet3 as tnn
from torchain_tpu_torch.graphs import transition_model as ttm


@pytest.fixture(scope="module")
def mdl(tmp_path_factory):
    """A final.mdl written by the JAX package; (path, its bytes)."""
    nnet = _tdnnf_style_nnet(np.random.default_rng(11))
    am = jnn.AmNnet(nnet=nnet, left_context=4, right_context=4,
                    priors=np.linspace(-1, 1, 10).astype(np.float32))
    path = str(tmp_path_factory.mktemp("mdl") / "final.mdl")
    jnn.write_am_nnet(path, jchain(5), am)
    return path, open(path, "rb").read()


def test_read_and_write_bytes_equal_jax(mdl, tmp_path):
    path, want = mdl
    tm, am = tnn.read_am_nnet(path)
    out = str(tmp_path / "port.mdl")
    tnn.write_am_nnet(out, tm, am)
    assert open(out, "rb").read() == want
    jtm, jam = jnn.read_am_nnet(path)
    assert tm.tuples == jtm.tuples
    assert (am.left_context, am.right_context) == (jam.left_context, jam.right_context)
    np.testing.assert_array_equal(am.priors, jam.priors)
    assert ttm.read_transition_model(path).tuples == jtm.tuples


def test_config_lines_and_describe_equal_jax(mdl):
    path, _ = mdl
    _, am = tnn.read_am_nnet(path)
    _, jam = jnn.read_am_nnet(path)
    assert am.nnet.config_lines() == jam.nnet.config_lines()
    assert am.nnet.describe() == jam.nnet.describe()
    assert list(am.nnet.nodes) == list(jam.nnet.nodes)
    for name, c in jam.nnet.components.items():
        got = am.nnet.components[name]
        assert got.type == c.type and list(got.attrs) == list(c.attrs)
        for k, v in c.attrs.items():
            if isinstance(v, np.ndarray):
                assert got.attrs[k].dtype == v.dtype and np.array_equal(got.attrs[k], v), k
            else:
                assert got.attrs[k] == v, k


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_forward_equals_jax(mdl, seed):
    path, _ = mdl
    _, am = tnn.read_am_nnet(path)
    _, jam = jnn.read_am_nnet(path)
    rng = np.random.default_rng(seed)
    T = int(rng.integers(12, 40))
    inputs = {"input": rng.standard_normal((T, 8)).astype(np.float32),
              "ivector": rng.standard_normal((T, 4)).astype(np.float32)}
    t = np.arange(0, T, 3)
    got = am.nnet.forward(inputs, t)
    want = jam.nnet.forward(inputs, t)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_unknown_component_round_trips_and_refuses_to_forward():
    rng = np.random.default_rng(0)
    attrs = {"Dim": 8, "SelfRepairScale": 1e-5, "IsGradient": False,
             "ValueAvg": rng.random(8).astype(np.float32),
             "Params": rng.random((8, 8)).astype(np.float32)}
    bufs = []
    for mod in (jnn, tnn):
        nnet = mod.Nnet(
            nodes={"input": mod.Node("input", "input", dim=8),
                   "m": mod.Node("component", "m", component="mystery",
                                 input=mod.Desc.parse("input")),
                   "output": mod.Node("output", "output", input=mod.Desc.parse("m"))},
            components={"mystery": mod.Component("mystery", "FruitSaladComponent", dict(attrs))},
        )
        buf = io.BytesIO()
        nnet.write_binary(buf)
        bufs.append(buf.getvalue())
    assert bufs[1] == bufs[0]
    back = tnn.Nnet.read_binary(io.BytesIO(bufs[0]))
    assert back.components["mystery"].type == "FruitSaladComponent"
    with pytest.raises(NotImplementedError, match="FruitSalad"):
        back.forward({"input": np.zeros((4, 8), np.float32)}, np.array([1]))


@pytest.mark.parametrize("s", [
    "Append(Offset(input,-1),input,Offset(input,1))",
    "Sum(a,Scale(0.5,Offset(b,3)))",
    "Round(IfDefined(ivector),10)",
    "ReplaceIndex(ivector,t,0)",
    "Const(1.5,40)",
])
def test_descriptors_print_as_jax(s):
    assert tnn.Desc.parse(s).to_string() == jnn.Desc.parse(s).to_string()
