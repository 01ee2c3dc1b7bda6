"""Adam with bfloat16 moments in the PyTorch port (train/lowmem_adam.py)
against the JAX package's (torchain_tpu/train/lowmem_adam.py) on the CPU:

- `lowmem_adam_update` over 5 steps on a tree of 2-D, 3-D and 1-D tensors
  against `scale_by_adam_lowmem`'s update_fn: the updates within rel 1e-6
  (float32 arithmetic in another order: XLA's pow and fused multiply-adds),
  the stored moments equal or one bfloat16 step apart;
- `LowmemAdam` over 5 steps against optax's `adam_lowmem(lr)` chain applied
  to the parameters: the parameters within rel 1e-6 of the distance they
  moved;
- its state: bfloat16 moments, half the bytes of torch's Adam moments, a
  `state_dict` that survives a save and load (bfloat16 kept) and a resume
  that is bit-equal to the uncut run, and `ChainOptimizer` with
  `optimizer="adam-lowmem"` holding the same state.
"""

import io

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp
import optax
import torch

from torchain_tpu.train.lowmem_adam import adam_lowmem as j_adam_lowmem
from torchain_tpu.train.lowmem_adam import scale_by_adam_lowmem
from torchain_tpu_torch.train import ChainOptimizer, LowmemAdam, TrainerConfig
from torchain_tpu_torch.train.lowmem_adam import lowmem_adam_update

SHAPES = {"kernel": (6, 5), "conv": (2, 3, 4), "bias": (5,)}
STEPS = 5


def _grads(seed=0, steps=STEPS):
    rng = np.random.default_rng(seed)
    return [{k: (rng.normal(size=s) * 10.0 ** rng.integers(-3, 2)).astype(np.float32)
             for k, s in SHAPES.items()} for _ in range(steps)]


def _bf16_steps_apart(a: torch.Tensor, b: np.ndarray) -> int:
    """The largest distance, in bfloat16 steps, between two bfloat16 arrays
    (compared by their bit patterns, which order like the values within one
    sign)."""
    ia = a.view(torch.int16).numpy().astype(np.int64)
    ib = torch.tensor(np.asarray(b, dtype=np.float32)).to(torch.bfloat16).view(
        torch.int16).numpy().astype(np.int64)
    same_sign = (ia < 0) == (ib < 0)
    return int(np.where(same_sign, np.abs(ia - ib), np.abs(ia) + np.abs(ib)).max())


def test_update_matches_jax_over_five_steps():
    tx = scale_by_adam_lowmem()
    params = {k: jnp.zeros(s, jnp.float32) for k, s in SHAPES.items()}
    jstate = tx.init(params)
    mu = {k: torch.zeros(s, dtype=torch.bfloat16) for k, s in SHAPES.items()}
    nu = {k: torch.zeros(s, dtype=torch.bfloat16) for k, s in SHAPES.items()}
    for count, g in enumerate(_grads(), start=1):
        jup, jstate = tx.update({k: jnp.asarray(v) for k, v in g.items()}, jstate)
        assert int(jstate.count) == count
        for k, v in g.items():
            step, mu[k], nu[k] = lowmem_adam_update(torch.as_tensor(v), mu[k], nu[k], count)
            want = np.asarray(jup[k])
            np.testing.assert_allclose(step.numpy(), want, rtol=1e-6, atol=0, err_msg=k)
            assert mu[k].dtype == nu[k].dtype == torch.bfloat16
            assert jstate.mu[k].dtype == jnp.bfloat16
            assert _bf16_steps_apart(mu[k], jstate.mu[k]) <= 1, k
            assert _bf16_steps_apart(nu[k], jstate.nu[k]) <= 1, k


def _port_run(grads, lr, start=None, state=None):
    ps = [torch.nn.Parameter(torch.as_tensor(v).clone()) for v in start.values()]
    opt = LowmemAdam(ps, lr=lr)
    if state is not None:
        opt.load_state_dict(state)
    for g in grads:
        for p, v in zip(ps, g.values()):
            p.grad = torch.as_tensor(v).clone()
        opt.step()
    return ps, opt


def test_optimizer_matches_the_jax_chain():
    lr = 3e-2
    rng = np.random.default_rng(1)
    start = {k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
    tx = j_adam_lowmem(lr)
    jp = {k: jnp.asarray(v) for k, v in start.items()}
    js = tx.init(jp)
    grads = _grads(2)
    for g in grads:
        up, js = tx.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        jp = optax.apply_updates(jp, up)
    ps, opt = _port_run(grads, lr, start)
    for p, k in zip(ps, start):
        v = jp[k]
        moved = np.abs(np.asarray(v) - start[k]).max()
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(v), rtol=0,
                                   atol=1e-6 * moved + 1e-7, err_msg=k)
    assert opt.param_groups[0]["count"] == STEPS


def test_state_is_bf16_half_of_adams_and_resumes_bit_equal():
    rng = np.random.default_rng(3)
    start = {k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
    grads = _grads(4, steps=6)
    whole, opt = _port_run(grads, 1e-2, start)
    ps = [torch.nn.Parameter(torch.as_tensor(v).clone()) for v in start.values()]
    adam = torch.optim.Adam(ps)
    for p, v in zip(ps, grads[0].values()):
        p.grad = torch.as_tensor(v)
    adam.step()
    adam_bytes = sum(st[k].numel() * st[k].element_size() for st in adam.state.values()
                     for k in ("exp_avg", "exp_avg_sq"))
    assert opt.state_bytes() * 2 == adam_bytes
    # cut after 3 steps, saved and loaded through bytes, then 3 more
    first, cut = _port_run(grads[:3], 1e-2, start)
    buf = io.BytesIO()
    torch.save(cut.state_dict(), buf)
    buf.seek(0)
    state = torch.load(buf, weights_only=True)
    resumed, opt2 = _port_run(grads[3:], 1e-2, {k: p.detach().numpy() for k, p in
                                                 zip(start, first)}, state)
    assert all(st["mu"].dtype == torch.bfloat16 for st in opt2.state.values())
    for a, b in zip(whole, resumed):
        assert torch.equal(a, b)
    for a, b in zip(opt.state.values(), opt2.state.values()):
        assert torch.equal(a["mu"], b["mu"]) and torch.equal(a["nu"], b["nu"])


def test_chain_optimizer_takes_adam_lowmem():
    ps = [torch.nn.Parameter(torch.ones(3, 2)), torch.nn.Parameter(torch.zeros(2))]
    chain = ChainOptimizer(ps, TrainerConfig(optimizer="adam-lowmem", lr=1e-2, device="cpu"))
    assert isinstance(chain.inner, LowmemAdam)
    for p in ps:
        p.grad = torch.full_like(p, 0.5)
    assert chain.step()
    sd = chain.state_dict()
    assert sd["inner"]["param_groups"][0]["count"] == 1
    assert all(st["nu"].dtype == torch.bfloat16 for st in sd["inner"]["state"].values())
