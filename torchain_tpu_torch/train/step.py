"""The chain training step: model forward (two heads) -> chain loss (custom
gradient) -> gradients -> global-norm clip -> optimizer.  Port of
torchain_tpu/train/step.py (make_train_step, make_eval_step,
make_forward_fn, make_backstitch_step).

With `mesh` (parallel.Mesh, a data axis larger than 1) a step is one
rank's share of a data-parallel step: `feats`, `sup` are this rank's rows of
the global batch, the batchnorms and dropout see the global batch
(`parallel.data_parallel`), the loss is the global batch's, and after each
backward the gradients are summed over the data group, so grad_norm, the
clip and the optimizer read the global gradient on every rank.  A model
sharded over the mesh's model axis (`parallel.shard_params`) takes each
rank's block of its sharded leaves: the step sums the split products'
bias gradients over the model group, and the norm and the clip count a
replicated leaf once and a sharded one's squares over the model group."""

from __future__ import annotations

import torch

from torchain_tpu_torch.ops.chain_loss import ChainLossOptions, chain_loss
from torchain_tpu_torch.parallel.mesh import all_reduce_tensors_, data_parallel
from torchain_tpu_torch.parallel.sharding import model_grad_sums, squared_norms
from torchain_tpu_torch.train.captured import CapturedStep, check_capturable
from torchain_tpu_torch.train.state import ChainTrainState


def global_norm(grads: list[torch.Tensor], params=None) -> torch.Tensor:
    """optax.global_norm: the 2-norm of all the tensors together.  With
    `params` (the tensors' parameters) a leaf sharded over the model axis
    adds its squares summed over the model group."""
    return torch.sqrt(sum(squared_norms(grads, params)))


def clip_by_global_norm_(grads: list[torch.Tensor], max_norm: float,
                         params=None) -> torch.Tensor:
    """optax.clip_by_global_norm semantics: g * max_norm / ||g|| when
    ||g|| >= max_norm, else unchanged (torch's clip_grad_norm_ divides by
    ||g|| + 1e-6 instead).  Returns ||g|| before clipping (`params` as in
    `global_norm`)."""
    norm = global_norm(grads, params)
    factor = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    for g in grads:
        g.mul_(factor)
    return norm


def _grads(model, feats, den, sup, loss_opts, use_xent, dropout_rate=None, generator=None,
           mesh=None):
    """Forward, chain loss and backward into the parameters' .grad (with
    `mesh`, summed over the data group; a split product's bias gradients
    over the model group).  Returns (loss, aux) detached."""
    model.train()
    kw = {} if dropout_rate is None else dict(dropout_rate=dropout_rate, generator=generator)
    with data_parallel(mesh):
        chain_out, xent_out = model(feats, train=True, **kw)
        loss, aux = chain_loss(chain_out, xent_out if use_xent else None, den, sup, loss_opts,
                               mesh=mesh)
        model.zero_grad(set_to_none=False)
        loss.backward()
    model_grad_sums(model)
    if mesh is not None and mesh.data > 1:
        all_reduce_tensors_(mesh, [p.grad for p in model.parameters() if p.grad is not None])
    return loss.detach(), {k: v.detach() for k, v in aux.items()}


def make_train_step(
    state: ChainTrainState,
    loss_opts: ChainLossOptions,
    use_xent: bool = True,
    max_grad_norm: float = 5.0,
    dropout: bool = False,
    mesh=None,
    capture: bool = False,
):
    """Returns step(feats [B, T_in, F], den, sup) -> metrics, updating
    `state` in place (parameters, optimizer state, batchnorm running
    statistics, step count).  Metric keys: loss, objf, l2_term, oor_term,
    xent_objf, weight, num_failed, grad_norm (0-d tensors on the model's
    device; grad_norm is the norm before any clip).

    `max_grad_norm` > 0 clips the gradient before `state.optimizer` steps
    (the head of the JAX package's optax chain); pass 0 where the optimizer
    clips itself (`train.trainer.ChainOptimizer`, whose clip sees the
    accumulated gradient).  With `dropout=True` the step takes two more
    arguments, step(feats, den, sup, dropout_rate, generator): the rate a
    float, the masks drawn from the torch.Generator (the JAX step's traced
    rate and PRNG key).

    With `capture=True` the step is one CUDA graph captured on its first
    call and replayed on every later one (`train.captured.CapturedStep`:
    the counterpart of the JAX step's one jitted, donated program).  It
    needs a model on the card, torch's Adam built with capturable=True
    (`create_train_state(..., capturable=True)`), every batch of one shape
    (one set of supervision caps and one `L_cap`) and the same `den`; it
    raises ValueError for a CPU model, a mesh axis larger than 1 or
    dropout, where the step stays eager."""
    model, opt = state.model, state.optimizer
    params = [p for p in model.parameters() if p.requires_grad]

    def body(feats, den, sup, dropout_rate=None, generator=None) -> dict:
        rate, gen = (dropout_rate, generator) if dropout else (None, None)
        loss, metrics = _grads(model, feats, den, sup, loss_opts, use_xent, rate, gen, mesh)
        grads = [p.grad for p in params]
        if max_grad_norm and max_grad_norm > 0:
            grad_norm = clip_by_global_norm_(grads, max_grad_norm, params)
        else:
            grad_norm = global_norm(grads, params)
        opt.step()
        metrics["loss"] = loss
        metrics["grad_norm"] = grad_norm
        return metrics

    if capture:
        check_capturable(state, dropout, mesh)
        return CapturedStep(state, body)

    def step(feats, den, sup, dropout_rate=None, generator=None) -> dict:
        metrics = body(feats, den, sup, dropout_rate, generator)
        state.step += 1
        return metrics

    return step


def make_eval_step(loss_opts: ChainLossOptions, use_xent: bool = True, mesh=None):
    """Returns eval_step(model, feats, den, sup) -> the chain loss's aux
    dict (objf, l2_term, oor_term, xent_objf, weight, num_failed), with the
    model in eval mode (running batchnorm statistics) and no gradient: the
    denominator's backward (K2) never runs.  With `mesh` the inputs are
    this rank's rows and the sums are the global batch's."""

    @torch.no_grad()
    def eval_step(model, feats, den, sup) -> dict:
        model.eval()
        chain_out, xent_out = model(feats, train=False)
        _, aux = chain_loss(chain_out, xent_out if use_xent else None, den, sup, loss_opts,
                            mesh=mesh)
        return aux

    return eval_step


def make_forward_fn(model):
    """The posterior export path: forward(feats) -> the chain head's raw
    output [B, T_out, P] in eval mode.  Chain models decode the raw output
    as pseudo-loglikes with acoustic scale 1.0 and no prior division
    (latgen-faster-mapped in the chain recipes).  `forward.device` is the
    device of the model's parameters, where its input belongs."""

    @torch.no_grad()
    def forward(feats):
        model.eval()
        return model(feats, train=False)[0]

    forward.device = next(model.parameters()).device
    return forward


def make_backstitch_step(
    state: ChainTrainState,
    loss_opts: ChainLossOptions,
    alpha: float,
    use_xent: bool = True,
    mesh=None,
):
    """Backstitch training step (Kaldi --trainer.backstitch-training-scale,
    nnet-training.cc TrainInternalBackstitch; Wang et al. 2017): on one
    minibatch, a negative update scaled -alpha from the current parameters,
    then a positive one scaled (1 + alpha) from the moved point.  The
    scales apply to the optimizer's update (after its clip, learning rate
    and max-change), so `state.optimizer` must take `step(scale=...)`
    (`train.trainer.ChainOptimizer`); its state advances twice.  The
    batchnorm running statistics keep the second pass's update, and
    grad_norm is the norm of the second pass's gradient."""
    model, opt = state.model, state.optimizer
    params = [p for p in model.parameters() if p.requires_grad]
    stats = [b for _, b in model.named_buffers()]

    def step(feats, den, sup) -> dict:
        # pass 1 from the current point: its batchnorm update is undone
        saved = [b.clone() for b in stats]
        _grads(model, feats, den, sup, loss_opts, use_xent, mesh=mesh)
        opt.step(scale=-alpha)
        with torch.no_grad():
            for b, s in zip(stats, saved):
                b.copy_(s)
        # pass 2 from the moved point
        loss, metrics = _grads(model, feats, den, sup, loss_opts, use_xent, mesh=mesh)
        grad_norm = global_norm([p.grad for p in params], params)
        opt.step(scale=1.0 + alpha)
        state.step += 1
        metrics["loss"] = loss
        metrics["grad_norm"] = grad_norm
        return metrics

    return step
