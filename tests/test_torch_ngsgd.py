"""Natural-gradient SGD in the PyTorch port (train/ngsgd.py) against the JAX
package's (torchain_tpu/train/ngsgd.py) on the CPU.

Over 8 steps, crossing the two inverse refreshes at counts 4 and 8, on a
tree that holds every case `_eligible` tells apart at `max_dim` 6: a dense
kernel with both sides preconditioned, a conv kernel [2, 3, 4] viewed as
[6, 4], a kernel whose columns pass `max_dim` (one side only), one whose
rows do, and a 1-D bias that passes through whole:

- `precondition` against `natural_gradient`'s update_fn: each step's
  preconditioned gradients, and the covariances and inverses, within rel
  1e-4 of their largest magnitude (a float32 `torch.linalg.solve` against
  `jnp.linalg.solve`, through an 8-step moving average); the leaves that
  pass through are equal;
- `NGSGD` against optax's chain natural_gradient -> sgd(lr, momentum 0.9):
  the parameters within rel 1e-4 of the distance they moved;
- a resume from `state_dict` bit-equal to the uncut run, and
  `ChainOptimizer(optimizer="ngsgd")` putting the clip before it and
  max-change after it, as the JAX chain does
  (torchain_tpu/train/trainer.py make_optimizer).
"""

import io

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp
import optax
import torch

from torchain_tpu.train.ngsgd import NGOptions as JOpts
from torchain_tpu.train.ngsgd import natural_gradient
from torchain_tpu.train.trainer import TrainerConfig as JTrainerConfig
from torchain_tpu.train.trainer import make_optimizer as j_make_optimizer
from torchain_tpu_torch.train import NGSGD, ChainOptimizer, NGOptions, TrainerConfig
from torchain_tpu_torch.train.ngsgd import _eligible, precondition

SHAPES = {"dense": (5, 4), "conv": (2, 3, 4), "wide_cols": (3, 8), "tall_rows": (9, 2),
          "bias": (4,)}
MAX_DIM = 6
STEPS = 8


def _grads(seed=0, steps=STEPS):
    rng = np.random.default_rng(seed)
    return [{k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
            for _ in range(steps)]


def _rel_close(got, want, rel, what):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * max(float(np.abs(want).max()), 1e-30), err_msg=what)


def test_eligible_sides_are_the_jax_packages():
    from torchain_tpu.train.ngsgd import _eligible as j_eligible

    for s in [*SHAPES.values(), (1, 5), (2, 1024, 8), (2048, 3)]:
        assert _eligible(s, MAX_DIM) == j_eligible(s, MAX_DIM)
        assert _eligible(s, 1024) == j_eligible(s, 1024)
    assert _eligible(SHAPES["wide_cols"], MAX_DIM) == (3, None)
    assert _eligible(SHAPES["tall_rows"], MAX_DIM) == (None, 2)


def test_preconditioner_matches_jax_over_two_refreshes():
    opts = NGOptions(max_dim=MAX_DIM)
    tx = natural_gradient(JOpts(max_dim=MAX_DIM))
    jstate = tx.init({k: jnp.zeros(s) for k, s in SHAPES.items()})
    states = {}
    for k, s in SHAPES.items():
        row, col = _eligible(s, MAX_DIM)
        states[k] = {f"{side}_{w}": torch.eye(d) for side, d in (("row", row), ("col", col))
                     if d is not None for w in ("cov", "inv")}
    for count, g in enumerate(_grads(), start=1):
        jg, jstate = tx.update({k: jnp.asarray(v) for k, v in g.items()}, jstate)
        for k, v in g.items():
            got = precondition(torch.as_tensor(v), states[k], count, opts)
            if not states[k]:
                assert np.array_equal(got.numpy(), v), k  # passes through
            _rel_close(got, jg[k], 1e-4, f"{k} step {count}")
            row, col = jstate.sides[k]
            for side, js in (("row", row), ("col", col)):
                if js is None:
                    assert f"{side}_cov" not in states[k]
                    continue
                _rel_close(states[k][f"{side}_cov"], js.cov, 1e-4, f"{k} {side} cov")
                _rel_close(states[k][f"{side}_inv"], js.inv, 1e-4, f"{k} {side} inv")
    assert int(jstate.count) == STEPS


def _port_run(grads, start, lr=1e-2, state=None):
    ps = [torch.nn.Parameter(torch.as_tensor(v).clone()) for v in start.values()]
    opt = NGSGD(ps, lr=lr, momentum=0.9, opts=NGOptions(max_dim=MAX_DIM))
    if state is not None:
        opt.load_state_dict(state)
    for g in grads:
        for p, v in zip(ps, g.values()):
            p.grad = torch.as_tensor(v).clone()
        opt.step()
    return ps, opt


def test_ngsgd_matches_the_jax_chain():
    rng = np.random.default_rng(5)
    start = {k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
    tx = optax.chain(natural_gradient(JOpts(max_dim=MAX_DIM)), optax.sgd(1e-2, momentum=0.9))
    jp = {k: jnp.asarray(v) for k, v in start.items()}
    js = tx.init(jp)
    grads = _grads(6)
    for g in grads:
        up, js = tx.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        jp = optax.apply_updates(jp, up)
    ps, opt = _port_run(grads, start)
    for p, k in zip(ps, start):
        v = jp[k]
        moved = np.abs(np.asarray(v) - start[k]).max()
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(v), rtol=0,
                                   atol=1e-4 * moved, err_msg=k)
    assert opt.param_groups[0]["ng_count"] == STEPS


def test_resume_is_bit_equal():
    rng = np.random.default_rng(7)
    start = {k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
    grads = _grads(8, steps=10)
    whole, opt = _port_run(grads, start)
    first, cut = _port_run(grads[:5], start)
    buf = io.BytesIO()
    torch.save(cut.state_dict(), buf)
    buf.seek(0)
    resumed, opt2 = _port_run(grads[5:], {k: p.detach().numpy() for k, p in zip(start, first)},
                              state=torch.load(buf, weights_only=True))
    for a, b in zip(whole, resumed):
        assert torch.equal(a, b)
    for a, b in zip(opt.state.values(), opt2.state.values()):
        assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    assert opt.state_bytes() == opt2.state_bytes() > 0


def test_chain_optimizer_orders_clip_ng_sgd_max_change_as_the_jax_chain():
    rng = np.random.default_rng(9)
    start = {k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
    common = dict(optimizer="ngsgd", lr=5e-2, grad_clip=1.0, max_change_per_component=0.05,
                  max_param_change=0.08)
    tx = j_make_optimizer(JTrainerConfig(**common))
    jp = {k: jnp.asarray(v) for k, v in start.items()}
    js = tx.init(jp)
    ps = [torch.nn.Parameter(torch.as_tensor(v).clone()) for v in start.values()]
    chain = ChainOptimizer(ps, TrainerConfig(**common, device="cpu"))
    assert isinstance(chain.inner, NGSGD) and chain.inner.opts == NGOptions()
    for g in _grads(10, steps=5):
        up, js = tx.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        jp = optax.apply_updates(jp, up)
        for p, v in zip(ps, g.values()):
            p.grad = torch.as_tensor(v).clone()
        chain.step()
    for p, k in zip(ps, start):
        v = jp[k]
        moved = np.abs(np.asarray(v) - start[k]).max()
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(v), rtol=0,
                                   atol=1e-4 * moved, err_msg=k)
