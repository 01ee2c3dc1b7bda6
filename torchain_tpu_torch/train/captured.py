"""The train step as one captured CUDA graph: the counterpart of the JAX
package's step, one `jax.jit` program whose state is donated
(torchain_tpu/train/step.py `make_train_step`).

`make_train_step(..., capture=True)` returns a `CapturedStep`.  Its first
call (or `capture`) allocates static buffers shaped like that call's
features and supervision, snapshots the state (parameters, batchnorm
statistics, the optimizer's moments and step), runs one step on a side
stream so that everything a kernel wrapper does on the host at launch (a
library load, a shared-memory plan, the allocator's growth) happens outside
the capture, restores the snapshot, and captures forward, chain loss,
backward, clip and the optimizer's step as one graph.  Every call then
checks its inputs against the static shapes, copies them into the static
buffers and replays the graph: one launch a step.

What a replay needs of its inputs:

  * one shape for every batch of a run: the supervision padded to one set
    of caps (`ChainDataset.batches(sup_caps=estimate_sup_caps())`;
    flat-start `E2eChainDataset.batches(sup_caps=caps)` and
    `DeviceE2eSupervision.from_host(vocab_cap=caps[2])` with `caps =
    estimate_e2e_caps()`) and its live-arc lists to one width
    (`with_kernel_tables(L_cap=ChainDataset.estimate_live_arcs())`, flat-start
    `L_cap=caps[3]`); a mismatch raises and names the field;
  * the denominator graph it was captured with;
  * an optimizer that keeps its step on the card (`create_train_state(...,
    capturable=True)`): torch's default Adam reads its step count on the
    host, which a replay would freeze at the capture's.

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


def check_capturable(state, dropout: bool, mesh) -> None:
    """Raise ValueError where a step cannot be captured: dropout (its masks
    come from a host generator), a mesh axis larger than 1 (gloo cannot be
    captured, and NCCL across cards is untried), a model off the card, an
    optimizer other than Adam built with capturable=True."""
    if dropout:
        raise ValueError("capture=True: a step with dropout stays eager (its masks are drawn"
                         " from a host generator)")
    if mesh is not None and (mesh.data > 1 or mesh.model > 1):
        raise ValueError(f"capture=True: a mesh of data {mesh.data} x model {mesh.model} stays"
                         " eager (its collectives cannot be captured)")
    device = next(state.model.parameters()).device
    if device.type != "cuda":
        raise ValueError(f"capture=True: the model is on {device}; a CUDA graph runs on the"
                         " card only")
    opt = state.optimizer
    if not (isinstance(opt, torch.optim.Adam)
            and all(g.get("capturable") for g in opt.param_groups)):
        raise ValueError("capture=True needs torch's Adam built with capturable=True"
                         " (create_train_state(..., capturable=True)): another optimizer"
                         " reads its step count on the host")


class CapturedStep:
    """step(feats, den, sup) -> metrics as the eager step returns them
    (clones of the graph's outputs), replaying one captured graph.
    `body(feats, den, sup)` is the eager step without the host's step
    count, which this class advances."""

    def __init__(self, state, body):
        self.state, self.body = state, body
        self.graph = None
        #: the static inputs (feats, sup) and outputs (metrics)
        self.static = self.outputs = None
        self.den = None
        #: host seconds of the warm-up and the capture; the graph pool's bytes
        self.capture_s = 0.0
        self.pool_bytes = None

    def snapshot(self):
        """The state's tensors as they are now: the parameters, the
        buffers, and each parameter's optimizer state (none before the
        first step), for `restore`."""
        model, opt = self.state.model, self.state.optimizer
        with torch.no_grad():
            tensors = [t.detach().clone() for t in (*model.parameters(), *model.buffers())]
            moments = {p: {k: v.clone() for k, v in s.items() if isinstance(v, torch.Tensor)}
                       for p, s in opt.state.items()}
        return tensors, moments

    def restore(self, snap) -> None:
        """Put the state back as the snapshot had it.  A parameter that had
        no optimizer state yet gets Adam's initial state (zero moments, step
        0) in the tensors the warm-up made, which the graph then updates."""
        tensors, moments = snap
        model, opt = self.state.model, self.state.optimizer
        with torch.no_grad():
            for t, s in zip((*model.parameters(), *model.buffers()), tensors):
                t.copy_(s)
            for p, s in opt.state.items():
                for k, v in s.items():
                    if isinstance(v, torch.Tensor):
                        if p in moments:
                            v.copy_(moments[p][k])
                        else:
                            v.zero_()

    def capture(self, feats, den, sup) -> None:
        """Warm up, restore and capture on this batch's shapes (a set-up
        cost, timed in `capture_s`); a failed capture raises RuntimeError."""
        t0 = time.perf_counter()
        self.static = static_like(feats, sup)
        self.den = den
        snap = self.snapshot()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            self.body(*self._args())
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        self.restore(snap)
        # what torch.cuda.graph does on entry, so that the growth of reserved
        # memory over the capture is the graph's own pool
        gc.collect()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved()
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph):
                self.outputs = self.body(*self._args())
        except Exception as e:
            raise RuntimeError(f"capture of the train step failed: {e}") from e
        torch.cuda.synchronize()
        self.graph = graph
        self.pool_bytes = torch.cuda.memory_reserved() - reserved
        self.capture_s = time.perf_counter() - t0

    def _args(self):
        feats, sup = self.static
        return feats, self.den, sup

    def __call__(self, feats, den, sup) -> dict:
        if self.graph is None:
            self.capture(feats, den, sup)
        elif den is not self.den:
            raise ValueError("den: the captured step reads the denominator graph it was"
                             " captured with")
        copy_inputs_(self.static, feats, sup)
        self.graph.replay()
        self.state.step += 1
        return {k: v.clone() for k, v in self.outputs.items()}
