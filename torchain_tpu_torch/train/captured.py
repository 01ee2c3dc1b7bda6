"""Train and eval steps as captured CUDA graphs: the counterparts of the
JAX package's steps, each one `jax.jit` program (torchain_tpu/train/step.py
`make_train_step`, whose state is donated, `make_backstitch_step` and
`make_eval_step`).

`make_train_step(..., capture=True)` (and `make_backstitch_step`,
`make_eval_step`) returns a `CapturedStep`.  Its first call (or `capture`)
allocates static buffers shaped like that call's features and supervision,
snapshots the state (parameters, batchnorm statistics, the optimizer's
tensors), runs one step on a side stream so that everything a kernel
wrapper does on the host at launch (a library load, a shared-memory plan,
the allocator's growth) happens outside the capture, restores the
snapshot, and captures the step as one graph.  Every call then checks its
inputs against the static shapes, copies them into the static buffers and
replays the graph.

What a replay needs of its inputs:

  * the batch's shapes: the supervision padded to one set of caps
    (`ChainDataset.batches(sup_caps=estimate_sup_caps())`; flat-start
    `E2eChainDataset.batches(sup_caps=caps)` and
    `DeviceE2eSupervision.from_host(vocab_cap=caps[2])` with `caps =
    estimate_e2e_caps()`) and its live-arc lists to one width
    (`with_kernel_tables(L_cap=ChainDataset.estimate_live_arcs())`, flat-start
    `L_cap=caps[3]`); a `CapturedStep` takes one shape and a mismatch
    raises and names the field (`Trainer` keeps one a shape, `shape_key`);
  * the denominator graph it was captured with;
  * an optimizer that keeps its state on the card: torch's Adam built with
    capturable=True (`create_train_state(..., capturable=True)`), or the
    Trainer's chain (`train.chain_tx.ChainOptimizer`) with the kinds of its
    calls fixed by the caller (`update`); torch's default Adam reads its
    step count on the host, which a replay would freeze at the capture's;
  * with dropout, a rate (copied into a device scalar before each replay)
    and one torch.Generator, registered with the graph so that each replay
    draws from its seed and offset as they are then (the Trainer seeds it
    with the step before each call, as it does eagerly).

The kernel wrappers count their launches in Python, which a replay does not
run: their counters move in the warm-up and the capture, never in a replay.
A replay's launches are read from a trace of it (`chip_smoke.py`
`check_captured`)."""

from __future__ import annotations

import dataclasses
import gc
import time

import torch


def static_like(feats: torch.Tensor, sup):
    """Static buffers for a captured step: a copy of `feats` and of the
    supervision `sup` (`DeviceSupervision` or `DeviceE2eSupervision`, every
    tensor field and its kernel tables cloned), which `copy_inputs_` refills
    batch after batch."""
    fields = {}
    for f in dataclasses.fields(sup):
        v = getattr(sup, f.name)
        if isinstance(v, torch.Tensor):
            fields[f.name] = v.clone()
        elif isinstance(v, tuple):
            fields[f.name] = tuple(x.clone() for x in v)
    return feats.clone(), dataclasses.replace(sup, **fields)


def _same(name: str, static, new) -> None:
    if isinstance(static, torch.Tensor) and isinstance(new, torch.Tensor):
        if static.shape != new.shape or static.dtype != new.dtype:
            raise ValueError(f"{name}: the captured step takes {static.dtype}"
                             f" {tuple(static.shape)}, got {new.dtype} {tuple(new.shape)}")
    elif isinstance(static, tuple) and isinstance(new, tuple) and len(static) == len(new):
        for i, (a, b) in enumerate(zip(static, new)):
            _same(f"{name}[{i}]", a, b)
    elif type(static) is not type(new) or (
            not isinstance(static, (torch.Tensor, tuple)) and static != new):
        raise ValueError(f"{name}: the captured step takes {static!r}, got {new!r}")


def copy_inputs_(static: tuple, feats: torch.Tensor, sup) -> None:
    """Check a batch against the static buffers of `static_like` (the
    type, every shape, dtype and size field; a mismatch raises ValueError
    and names the field), then copy it in."""
    s_feats, s_sup = static
    _same("feats", s_feats, feats)
    if type(sup) is not type(s_sup):
        raise ValueError(f"sup: the captured step takes a {type(s_sup).__name__},"
                         f" got a {type(sup).__name__}")
    pairs = [(s_feats, feats)]
    for f in dataclasses.fields(sup):
        a, b = getattr(s_sup, f.name), getattr(sup, f.name)
        _same(f"sup.{f.name}", a, b)
        if isinstance(a, torch.Tensor):
            pairs.append((a, b))
        elif isinstance(a, tuple):
            pairs.extend(zip(a, b))
    with torch.no_grad():
        for a, b in pairs:
            a.copy_(b, non_blocking=True)


def shape_key(feats: torch.Tensor, sup) -> tuple:
    """What a captured step fixes of a batch, as a dict key: the shape and
    dtype of `feats` and of every tensor of the supervision, and its other
    fields' values."""
    def key(v):
        if isinstance(v, torch.Tensor):
            return tuple(v.shape), v.dtype
        if isinstance(v, tuple):
            return tuple(key(x) for x in v)
        return v

    return (key(feats), type(sup).__name__,
            tuple(key(getattr(sup, f.name)) for f in dataclasses.fields(sup)))


def check_on_card(model) -> None:
    """ValueError where `model` is off the card: a CUDA graph runs there
    only."""
    device = next(model.parameters()).device
    if device.type != "cuda":
        raise ValueError(f"capture=True: the model is on {device}; a CUDA graph runs on the"
                         " card only")


def check_capturable(state, dropout: bool, mesh, update=None) -> None:
    """Raise ValueError where a step cannot be captured: a mesh axis larger
    than 1 (gloo cannot be captured, and NCCL across cards is untried), a
    model off the card, dropout where torch cannot register a generator
    with a graph, an optimizer that reads its state on the host (anything
    but torch's Adam built with capturable=True, and the Trainer's chain
    given `update`, the call that fixes the kinds of its steps)."""
    if mesh is not None and (mesh.data > 1 or mesh.model > 1):
        raise ValueError(f"capture=True: a mesh of data {mesh.data} x model {mesh.model} stays"
                         " eager (its collectives cannot be captured)")
    if dropout and not hasattr(torch.cuda.CUDAGraph, "register_generator_state"):
        raise ValueError("capture=True: this torch cannot register a generator with a graph"
                         " (CUDAGraph.register_generator_state), so a step with dropout stays"
                         " eager")
    check_on_card(state.model)
    opt = state.optimizer
    if getattr(opt, "capturable", False):
        if update is None:
            raise ValueError("capture=True with the Trainer's chain needs `update`, the call"
                             " that fixes the kinds of its steps (as Trainer(capture=True)"
                             " gives)")
        return
    if not (isinstance(opt, torch.optim.Adam)
            and all(g.get("capturable") for g in opt.param_groups)):
        raise ValueError("capture=True needs torch's Adam built with capturable=True"
                         " (create_train_state(..., capturable=True)) or the Trainer's chain:"
                         " another optimizer reads its step count on the host")


class CapturedStep:
    """step(feats, den, sup[, dropout_rate, generator]) -> metrics as the
    eager step returns them (clones of the graph's outputs), replaying one
    captured graph.  `body(feats, den, sup[, rate, generator])` is the
    eager step without the host's step count, which this class advances
    (where `state` is given: None for an eval step, which changes no
    state).  Graphs that share `pool` (`torch.cuda.graph_pool_handle()`)
    share their memory: they must replay one at a time, and each call
    clones its outputs before another replays."""

    def __init__(self, state, body, pool=None):
        self.state, self.body, self.pool = state, body, pool
        self.graph = None
        #: the static inputs (feats, sup) and outputs (metrics)
        self.static = self.outputs = None
        self.den = None
        #: the dropout rate's device scalar and the registered generator
        self.rate = self.generator = None
        #: host seconds of the warm-up and the capture; the graph pool's
        #: growth over the capture, in bytes
        self.capture_s = 0.0
        self.pool_bytes = None

    def _state_tensors(self):
        model, opt = self.state.model, self.state.optimizer
        return [*model.parameters(), *model.buffers(),
                *(opt.tensors() if hasattr(opt, "tensors") else ())]

    def snapshot(self):
        """The state's tensors as they are now: the parameters, the
        buffers, the Trainer's chain's tensors, or each parameter's torch
        optimizer state (none before the first step), for `restore`."""
        if self.state is None:
            return None
        opt = self.state.optimizer
        with torch.no_grad():
            tensors = [t.detach().clone() for t in self._state_tensors()]
            moments = ({} if hasattr(opt, "tensors") else
                       {p: {k: v.clone() for k, v in s.items() if isinstance(v, torch.Tensor)}
                        for p, s in opt.state.items()})
        return tensors, moments

    def restore(self, snap) -> None:
        """Put the state back as the snapshot had it.  A parameter that had
        no torch optimizer state yet gets Adam's initial state (zero
        moments, step 0) in the tensors the warm-up made, which the graph
        then updates."""
        if self.state is None:
            return
        tensors, moments = snap
        opt = self.state.optimizer
        with torch.no_grad():
            for t, s in zip(self._state_tensors(), tensors):
                t.copy_(s)
            if hasattr(opt, "tensors"):
                return
            for p, s in opt.state.items():
                for k, v in s.items():
                    if isinstance(v, torch.Tensor):
                        if p in moments:
                            v.copy_(moments[p][k])
                        else:
                            v.zero_()

    def capture(self, feats, den, sup, *dropout) -> None:
        """Warm up, restore and capture on this batch's shapes (a set-up
        cost, timed in `capture_s`); a failed capture raises RuntimeError.
        With `dropout` (rate, generator) the generator is registered with
        the graph and seeded again with its seed after the capture."""
        self.static = static_like(feats, sup)
        self.den = den
        if dropout:
            rate, self.generator = dropout
            self.rate = torch.tensor(float(rate), dtype=torch.float32, device=feats.device)
            seed = self.generator.initial_seed()
        self.outputs = self._record(self._args())
        if dropout:
            self.generator.manual_seed(seed)

    def _record(self, args):
        """The body on `args`: once on a side stream between a snapshot of
        the state and its restore, then captured; returns what the capture
        returned (the graph's outputs)."""
        t0 = time.perf_counter()
        snap = self.snapshot()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            self.body(*args)
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        self.restore(snap)
        # what torch.cuda.graph does on entry, so that the growth of reserved
        # memory over the capture is the graph's own pool
        gc.collect()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved()
        graph = torch.cuda.CUDAGraph()
        if self.generator is not None:
            graph.register_generator_state(self.generator)
        try:
            with torch.cuda.graph(graph, pool=self.pool):
                outputs = self.body(*args)
        except Exception as e:
            raise RuntimeError(f"capture of the step failed: {e}") from e
        torch.cuda.synchronize()
        self.graph = graph
        self.pool_bytes = torch.cuda.memory_reserved() - reserved
        self.capture_s = time.perf_counter() - t0
        return outputs

    def _args(self):
        feats, sup = self.static
        extra = () if self.generator is None else (self.rate, self.generator)
        return (feats, self.den, sup, *extra)

    def __call__(self, feats, den, sup, *dropout) -> dict:
        if self.graph is None:
            self.capture(feats, den, sup, *dropout)
        elif den is not self.den:
            raise ValueError("den: the captured step reads the denominator graph it was"
                             " captured with")
        if bool(dropout) != (self.generator is not None) or (
                dropout and dropout[1] is not self.generator):
            raise ValueError("generator: the captured step draws from the generator it was"
                             " captured with")
        copy_inputs_(self.static, feats, sup)
        if dropout:
            self.rate.fill_(float(dropout[0]))
        self.graph.replay()
        if self.state is not None:
            self.state.step += 1
        return {k: v.clone() for k, v in self.outputs.items()}


class CapturedCall(CapturedStep):
    """fn() on the state, in place, replayed from one graph with no inputs
    or outputs (the Trainer's semi-orthogonal constraint between its
    captured steps); warmed up and captured at its first call as a
    `CapturedStep` is.  It does not count a step."""

    def __init__(self, state, fn, pool=None):
        super().__init__(state, lambda: fn(), pool)

    def __call__(self) -> None:
        if self.graph is None:
            self._record(())
        self.graph.replay()
