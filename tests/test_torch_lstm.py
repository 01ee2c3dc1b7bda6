"""The recurrent trunk of the PyTorch port (models/lstm.py) against the JAX
package's (torchain_tpu/models/lstm.py) on the CPU, from the same parameters
(convert.params_from_jax for the whole model):

- `Lstmp` alone at delays 1, 2 and 3 over T = 7 frames (not a multiple of
  2 or 3: the phase chains are padded), and `Opgru` alone at delays 1 and
  2: the outputs and the gradients of a fixed scalar of them with respect
  to every parameter and to the input, with peepholes, biases and u_h
  moved off their zero initialisation so that each one matters;
- `TDNNLSTM` on a small ladder that holds TDNN layers (one strided), an
  LSTMP layer and an OPGRU layer at delay 2, with 2 warm-up frames: train
  mode (both outputs, every parameter's gradient, the running statistics)
  and eval mode;

each with a float32 and a bfloat16 trunk.

Tolerances, float32: the layers' outputs and gradients within rel 1e-5 of
their largest magnitude; the model's outputs and statistics atol 1e-5,
each gradient rtol 1e-4 plus 1e-5 of its largest magnitude, as
tests/test_torch_tdnn.py holds TDNN-F (4.1e-6 seen).  bfloat16: the gates,
the cell and the nonlinearities run in float32 on both sides, and the port
rounds the products where XLA does, so no XLA logistic stand-in is needed
and the layers' outputs agree bit for bit here; the layers are held within
3e-2 of their largest magnitude (gradients to 1.2e-2 seen: the backward's
bfloat16 products round in other orders), the model's outputs atol 1e-5
(through the float32 heads) and its gradients within 5e-2 of their largest
magnitude, the bfloat16 conformer's bound (3.8e-2 seen, on tdnn0's bias, a
bfloat16 sum over all rows).
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax
import jax.numpy as jnp
import torch

from tests.test_torch_lowerings import DTYPES, check_eval, check_train, cli_cut_and_resume, jax_case
from torchain_tpu.models import TDNNLSTM as JTDNNLSTM
from torchain_tpu.models import Lstmp as JLstmp
from torchain_tpu.models import Opgru as JOpgru
from torchain_tpu.models import TdnnLstmConfig as JCfg
from torchain_tpu_torch.convert import params_from_jax
from torchain_tpu_torch.models import TDNNLSTM, Lstmp, Opgru, TdnnLstmConfig

T, B, C = 7, 3, 5
CELL, REC, NONREC = 6, 3, 2
LAYER_RTOL = {"float32": 1e-5, "bfloat16": 3e-2}


def _layer_case(kind, delay, dtype, seed=0):
    jd, td = DTYPES[dtype]
    jcls, tcls = (JLstmp, Lstmp) if kind == "lstm" else (JOpgru, Opgru)
    jm = jcls(cell_dim=CELL, rec_proj_dim=REC, nonrec_proj_dim=NONREC, delay=delay, dtype=jd)
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(T, B, C)).astype(np.float32)
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
    # peepholes, biases and u_h off zero: every parameter matters
    params = jax.tree.map(
        lambda v: v + jnp.asarray((0.3 * rng.normal(size=v.shape)).astype(np.float32)), params)
    tm = tcls(C, CELL, REC, NONREC, delay, device="cpu", dtype=td)
    tm.load_state_dict({k: torch.tensor(np.asarray(v)) for k, v in params.items()})
    w = rng.normal(size=(T, B, REC + NONREC)).astype(np.float32)
    return jm, params, tm, x, w


def _close(got, want, rel, what):
    want = np.asarray(want, dtype=np.float32)
    np.testing.assert_allclose(np.asarray(got, dtype=np.float32), want, rtol=0,
                               atol=rel * max(float(np.abs(want).max()), 1e-30), err_msg=what)


def _check_layer(kind, delay, dtype):
    jm, params, tm, x, w = _layer_case(kind, delay, dtype)

    def jfn(p, xx):
        y = jm.apply({"params": p}, xx)
        return jnp.sum(y.astype(jnp.float32) * w), y

    (_, jy), (jgp, jgx) = jax.value_and_grad(jfn, argnums=(0, 1), has_aux=True)(
        params, jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    ty = tm(xt)
    assert ty.shape == (T, B, REC + NONREC) and ty.dtype == DTYPES[dtype][1]
    torch.sum(ty.float() * torch.as_tensor(w)).backward()
    rel = LAYER_RTOL[dtype]
    _close(ty.detach().float(), jy, rel, "output")
    _close(xt.grad, jgx, rel, "input gradient")
    named = dict(tm.named_parameters())
    assert set(named) == set(jgp)
    for k, g in jgp.items():
        _close(named[k].grad, g, rel, k)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("delay", [1, 2, 3])
def test_lstmp_matches_jax(delay, dtype):
    _check_layer("lstm", delay, dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("delay", [1, 2])
def test_opgru_matches_jax(delay, dtype):
    _check_layer("gru", delay, dtype)


def test_delay_is_independent_phase_chains():
    """A delay-d layer is d independent delay-1 chains over the frames t mod
    d: the port's folded loop gives what running each phase alone gives."""
    _, _, tm, x, _ = _layer_case("lstm", 3, "float32")
    one = Lstmp(C, CELL, REC, NONREC, 1, device="cpu")
    one.load_state_dict(tm.state_dict())
    with torch.no_grad():
        y = tm(torch.as_tensor(x))
        for ph in range(3):
            np.testing.assert_allclose(y[ph::3].numpy(), one(torch.as_tensor(x[ph::3])).numpy(),
                                       rtol=1e-6, atol=1e-7)


SMALL = dict(num_pdfs=7, hidden_dim=16, cell_dim=12, rec_proj_dim=4, nonrec_proj_dim=4,
             prefinal_dim=8, warmup_frames=2,
             layers=(("tdnn", 3, 1, 1), ("tdnn", 3, 1, 3), ("lstm", 1), ("tdnn", 3, 1, 1),
                     ("gru", 2)))
B_MODEL, T_OUT, FEAT = 2, 5, 6


@pytest.fixture(scope="module", params=list(DTYPES))
def model_case(request):
    jd, td = DTYPES[request.param]
    jcfg, tcfg = JCfg(dtype=jd, **SMALL), TdnnLstmConfig(dtype=td, **SMALL)
    assert jcfg.context == tcfg.context and jcfg.frame_subsampling_factor == 3
    left, right = tcfg.context
    feats = np.random.default_rng(2).normal(
        size=(B_MODEL, T_OUT * 3 + left + right, FEAT)).astype(np.float32)
    case = jax_case(JTDNNLSTM(jcfg), TDNNLSTM(tcfg, FEAT, device="cpu"), feats,
                    (B_MODEL, T_OUT, SMALL["num_pdfs"]), perturb=0.1)
    return case, request.param


def test_tdnn_lstm_eval_matches_jax(model_case):
    case, _ = model_case
    check_eval(case, atol=1e-5)


def test_tdnn_lstm_train_matches_jax(model_case):
    case, dtype = model_case
    if dtype == "float32":
        check_train(case)
    else:
        check_train(case, g_rtol=0.0, g_atol=5e-2)


def test_tdnn_lstm_context_and_names():
    """The context counts the warm-up frames at the input rate, the ladder's
    layer names and shapes are flax's, and params_from_jax refuses a tree
    of another ladder."""
    cfg = TdnnLstmConfig()
    assert cfg.context == JCfg().context == (60, 42) and cfg.frame_subsampling_factor == 3
    m = TDNNLSTM(TdnnLstmConfig(**SMALL), FEAT, device="meta")
    sd = m.state_dict()
    assert sd["lstm2.w_x"].shape == (16, 48) and sd["lstm2.w_r"].shape == (4, 48)
    assert sd["gru4.u_s"].shape == (4, 24) and sd["gru4.w_rm"].shape == (12, 8)
    assert sd["tdnn0.kernel"].shape == (3, FEAT, 16) and "BatchNorm_3.mean" in sd
    jm = JTDNNLSTM(JCfg(**{**SMALL, "layers": SMALL["layers"][:3]}))
    v = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 40, FEAT)), train=False)
    with pytest.raises(ValueError, match="mismatch"):
        params_from_jax(v["params"], v["batch_stats"], TdnnLstmConfig(**SMALL))
    with pytest.raises(ValueError, match="not ported"):
        TdnnLstmConfig(bn_impl="scan")


@pytest.mark.parametrize("optimizer", ["adam-lowmem", "ngsgd"])
def test_train_cli_tdnn_lstm_cut_and_resume_bit_equal(tmp_path, optimizer):
    cli_cut_and_resume(tmp_path, "tdnn-lstm", optimizer)
