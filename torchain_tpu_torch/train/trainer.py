"""Trainer: the end-to-end chain training loop (torch), port of
torchain_tpu/train/trainer.py for one device.

The torchain example recipe's training stage (argparse, per-interval
ChainResults, periodic checkpoints), with the optimizer chain the JAX
package builds from optax (clip -> Adam or SGD at an exponentially decaying
learning rate -> Kaldi max-change, under gradient accumulation), the
periodic semi-orthogonal constraint of TDNN-F, Kaldi's dropout schedule,
backstitch, JSONL metrics, and checkpoints that hold the whole train state
(model, optimizer, loader position) for an exact resume.

The device is explicit (`TrainerConfig.device`, default "cuda"): the model
must live there.  On a CUDA device each batch is placed on a side stream
by the prefetch thread, and the step's stream waits on an event recorded
after the placement.

Data parallelism (`TrainerConfig.mesh`, one process a card in a process
group: parallel.init_distributed): rank 0's parameters and buffers are
broadcast at construction; each rank loads its rows of every global batch
(`batch_size` is the global batch) and the step sums the gradients over the
ranks (train/step.py), so every rank takes the same update.  Every rank
stops at the same batch; checkpoints are written by rank 0 and read by
every rank; `evaluate` reports the global batch's statistics.

A model axis (`MeshConfig.model` > 1) is taken as the JAX `Trainer` takes
it: the data axis is world / model, the ranks of a model group read the
same rows (their data rank's), and the state stays replicated on every
rank (the JAX `Trainer` shards none of it; `parallel.shard_params` is the
sharded step's, outside the `Trainer`).  The loaders, the batchnorms, the
loss and `evaluate` read the data rank and the data size.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import inspect
import json
import os
import pathlib
import shutil
import statistics
import time

import numpy as np
import torch

from torchain_tpu_torch.data.loader import ChainBatch
from torchain_tpu_torch.data.materialize import MaterializedBatches, PlacedBatch
from torchain_tpu_torch.data.prefetch import Prefetcher
from torchain_tpu_torch.graphs.e2e import E2eSupervision
from torchain_tpu_torch.models.semi_orthogonal import (
    constrain_semi_orthogonal,
    constrained_parameters,
)
from torchain_tpu_torch.ops.chain_loss import ChainLossOptions, ChainResults
from torchain_tpu_torch.ops.device_graphs import DeviceSupervision
from torchain_tpu_torch.ops.num_e2e import DeviceE2eSupervision
from torchain_tpu_torch.ops.sharded import shardable
from torchain_tpu_torch.parallel.mesh import (
    MeshConfig,
    barrier,
    broadcast_object,
    host_min,
    make_mesh,
    replicated,
    shard_batch,
)
from torchain_tpu_torch.train.captured import (
    CapturedCall,
    CapturedStep,
    check_capturable,
    shape_key,
)
from torchain_tpu_torch.train.chain_tx import (  # noqa: F401 (the chain's names, kept here)
    ChainOptimizer,
    lr_schedule,
    make_optimizer,
    max_change,
)
from torchain_tpu_torch.train.state import ChainTrainState
from torchain_tpu_torch.train.step import (
    make_backstitch_step,
    make_eval_step,
    make_train_step,
)

#: checkpoints kept under checkpoint_dir, newest first (orbax max_to_keep)
KEEP_CHECKPOINTS = 3
_CKPT_FILE = "state.pt"


@dataclasses.dataclass
class TrainerConfig:
    lr: float = 1e-3
    #: Kaldi-recipe exponential LR decay: when set (> 0) the learning rate
    #: decays from `lr` to `lr_final` over `lr_decay_steps` optimizer
    #: steps (lr(t) = lr * (lr_final/lr)^(t/steps), the nnet3 train.py
    #: schedule), then holds at lr_final
    lr_final: float = 0.0
    lr_decay_steps: int = 0
    momentum: float = 0.9
    #: adam | adam-lowmem (bfloat16 moments) | sgd | ngsgd (Kaldi's
    #: natural-gradient SGD)
    optimizer: str = "adam"
    grad_clip: float = 5.0
    #: accumulate gradients over N micro-batches before each optimizer
    #: update (optax.MultiSteps); the effective batch is N * batch_size
    #: with the same per-step device memory
    grad_accum_steps: int = 1
    loss: ChainLossOptions = dataclasses.field(default_factory=ChainLossOptions)
    batch_size: int = 16
    num_epochs: int = 2
    #: apply the semi-orthogonal constraint every N steps (0 = never)
    semi_ortho_every: int = 4
    #: cycle the loader's input frame shift through 0..fsf-1 across epochs
    #: (Kaldi's frame-shift egs augmentation)
    frame_shift_cycle: bool = False
    #: Kaldi --trainer.dropout-schedule, e.g. "0,0@0.20,0.5@0.50,0":
    #: comma-separated value[@data_fraction] knots, piecewise-linear in the
    #: fraction of training processed; "" disables dropout entirely
    dropout_schedule: str = ""
    #: Kaldi max-change: cap each component's parameter delta (post-LR) at
    #: this 2-norm (recipe default 0.75; 0 = off)
    max_change_per_component: float = 0.0
    #: Kaldi --trainer.max-param-change: cap the global update 2-norm
    #: (recipe default 2.0; 0 = off)
    max_param_change: float = 0.0
    #: Kaldi --trainer.backstitch-training-scale (0 = off): two-pass
    #: updates, -scale then +(1+scale), on every `backstitch_interval`-th
    #: step (see train/step.py make_backstitch_step)
    backstitch_scale: float = 0.0
    backstitch_interval: int = 1
    log_every: int = 20
    #: thread-pool width for host-side batch assembly (ChainDataset.batches
    #: num_threads); None takes `default_loader_threads()`, 0 is serial
    loader_threads: int | None = None
    checkpoint_dir: str | None = None
    checkpoint_every: int = 500
    use_xent: bool = True
    #: the torch device the model lives on and batches are placed on
    device: str = "cuda"
    #: the (data, model) layout of the process group (data -1: every
    #: process; without a process group, this one)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    #: every step replayed from a captured CUDA graph (train/captured.py):
    #: one a kind of step (plain or with dropout, backstitch; accumulate or
    #: update), the semi-orthogonal constraint one more, `evaluate` one a
    #: batch shape; batches placed at one shape a run (live-arc lists to
    #: `estimate_live_arcs`, flat-start to `estimate_e2e_caps`; a dataset
    #: with neither raises ValueError).  On the card only, with no mesh
    #: axis larger than 1 (ValueError)
    capture: bool = False


def parse_dropout_schedule(schedule: str):
    """Kaldi dropout-schedule string -> callable(progress in [0,1]) -> rate.

    Format (steps/libs/nnet3/train/common.py): comma-separated ``value`` or
    ``value@fraction`` knots; an omitted fraction pins the first knot to
    0.0 and the last to 1.0, intermediate knots must carry fractions;
    linear interpolation between knots."""
    parts = [p.strip() for p in schedule.split(",") if p.strip()]
    if not parts:
        return lambda progress: 0.0
    knots: list[tuple[float, float]] = []
    for i, p in enumerate(parts):
        if "@" in p:
            v, f = p.split("@")
            knots.append((float(f), float(v)))
        elif i == 0:
            knots.append((0.0, float(p)))
        elif i == len(parts) - 1:
            knots.append((1.0, float(p)))
        else:
            raise ValueError(
                f"dropout-schedule knot {p!r} needs an @fraction "
                f"(only first/last may omit it): {schedule!r}"
            )
    if knots[0][0] > 0.0:
        knots.insert(0, (0.0, knots[0][1]))
    if knots[-1][0] < 1.0:
        knots.append((1.0, knots[-1][1]))
    fr = np.asarray([k[0] for k in knots])
    if (np.diff(fr) < 0).any():
        raise ValueError(f"dropout-schedule fractions must be sorted: {schedule!r}")
    val = np.asarray([k[1] for k in knots])

    def rate(progress: float) -> float:
        return float(np.interp(np.clip(progress, 0.0, 1.0), fr, val))

    return rate


def _leaves(obj):
    """The tensors and numpy arrays of a device graph or supervision
    (dataclass fields, tuples and lists, recursively), with the other
    fields' values, in field order."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            yield from _leaves(getattr(obj, f.name))
    elif isinstance(obj, (tuple, list)):
        for x in obj:
            yield from _leaves(x)
    else:
        yield obj


def den_fingerprint(den_device) -> str:
    """Content hash of a device denominator graph (arrays and static
    fields).  A resumed run whose den graph changed would silently optimize
    a different objective; checkpoints record this and refuse such
    resumes."""
    h = hashlib.sha256()
    for leaf in _leaves(den_device):
        if isinstance(leaf, torch.Tensor):
            h.update(leaf.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy())
        elif isinstance(leaf, np.ndarray):
            h.update(np.ascontiguousarray(leaf).tobytes())
        else:
            h.update(repr(leaf).encode())
    h.update(type(den_device).__name__.encode())
    return h.hexdigest()[:16]


def tree_fingerprint(tree) -> str:
    """Content hash of a pdf map (ContextTree params or a tied tree's
    table)."""
    if hasattr(tree, "pdf_map"):
        return hashlib.sha256(np.asarray(tree.pdf_map).tobytes()).hexdigest()[:16]
    return (
        f"ContextTree({tree.num_phones},{tree.context_width},"
        f"{getattr(tree, 'tie_self_loops', True)})"
    )


def default_loader_threads() -> int:
    """Half the host's cores, at most 4; the rest keep the prefetch and
    dispatch threads.  On an H100 machine's 8 cores, 4 threads took a live
    B=128 ChainDataset under `fit` from ~91 to 57-63 ms between steps
    (chip_smoke.py, wav (e))."""
    return min(4, (os.cpu_count() or 1) // 2)


def _config_to_jsonable(cfg) -> dict:
    def clean(x):
        if isinstance(x, dict):
            return {k: clean(v) for k, v in x.items()}
        if isinstance(x, (np.floating, np.integer)):
            return x.item()
        return x

    return clean(dataclasses.asdict(cfg))


def _tensors(obj):
    return [t for t in _leaves(obj) if isinstance(t, torch.Tensor)]


class Trainer:
    """`model` (a TDNNF, TDNN or Conformer on `cfg.device`), `den_device`
    (from auto_den_graph on the same device) and the config; `tree` (the
    ContextTree), where given, is fingerprinted into the checkpoints.

    With `cfg.capture` the host plans the kinds of each step's optimizer
    calls (`ChainOptimizer.plan`: accumulate or update, NG-SGD's refresh;
    two for backstitch) and replays the step's graph for that plan and the
    batch's shape (`captured.shape_key`), as `jax.jit` keeps a program per
    shape; `fit` places every batch of a run at one shape, so a run
    captures one graph a plan, and `evaluate`'s last, smaller batch one
    more.  All share one memory pool.  Capture raises ValueError where the
    step cannot be captured (a CPU model, a mesh axis larger than 1,
    dropout where torch cannot register a generator with a graph, a
    dataset that cannot fix its batches' shape); no step falls back to the
    eager one."""

    def __init__(self, model, den_device, cfg: TrainerConfig, tree=None):
        self.cfg = cfg
        self.device = torch.device(cfg.device)
        self.model = model.to(self.device)
        self.den = den_device
        self.fingerprints = dict(
            den=den_fingerprint(den_device) if den_device is not None else None,
            tree=tree_fingerprint(tree) if tree is not None else None,
            model=type(model).__name__,
        )
        self._dropout_fn = (
            parse_dropout_schedule(cfg.dropout_schedule) if cfg.dropout_schedule else None
        )
        if cfg.backstitch_scale > 0 and self._dropout_fn is not None:
            raise ValueError(
                "backstitch_scale and dropout_schedule are mutually "
                "exclusive (the backstitch step carries no dropout rng)"
            )
        self.mesh = make_mesh(cfg.mesh, device_type=self.device.type)
        #: the mesh where its data axis is larger than 1, else None
        self.dp = self.mesh if self.mesh.data > 1 else None
        replicated(self.mesh, self.model)
        self.state = ChainTrainState(model=self.model,
                                     optimizer=make_optimizer(cfg, self.model.parameters()))
        if cfg.capture:
            # where a captured step cannot run, ValueError now
            check_capturable(self.state, self._dropout_fn is not None, self.mesh,
                             update=self.state.optimizer.apply)
        #: under capture, the live-arc lists' width and the flat-start
        #: vocabulary's of every batch of a run (`fit` estimates them)
        self._shapes = (None, None)
        #: the captured steps by kind, plan and batch shape, their graphs'
        #: memory pool, and the semi-orthogonal constraint's graph
        self._steps: dict = {}
        self._pool = torch.cuda.graph_pool_handle() if cfg.capture else None
        self._ortho = None
        # the optimizer clips (after accumulation): the step does not.  Under
        # data parallelism the step all-reduces every micro-batch's gradient,
        # so each micro-step's grad_norm is the global gradient's
        dropout = self._dropout_fn is not None
        self.backstitch_step = None
        if cfg.capture:
            self.train_step = functools.partial(self._chain_step,
                                                "dropout" if dropout else "plain")
            if cfg.backstitch_scale > 0:
                self.backstitch_step = functools.partial(self._chain_step, "backstitch")
        else:
            self.train_step = make_train_step(self.state, cfg.loss, use_xent=cfg.use_xent,
                                              max_grad_norm=0.0, dropout=dropout, mesh=self.dp)
            if cfg.backstitch_scale > 0:
                self.backstitch_step = make_backstitch_step(
                    self.state, cfg.loss, cfg.backstitch_scale, use_xent=cfg.use_xent,
                    mesh=self.dp)
        # per-step dropout noise from a generator seeded with the step:
        # a resumed run draws the same masks
        self._dropout_gen = (
            torch.Generator(device=self.device) if self._dropout_fn is not None else None)
        self._stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        self._batches_per_epoch: int | None = None
        self.results = ChainResults()
        self.metrics_log: list[dict] = []
        self.start_epoch = 0
        self.current_epoch = 0
        self.batch_in_epoch = 0
        self.skip_batches = 0
        self._sup_caps = None
        #: host seconds: estimate_sup_caps, each batch's placement (on the
        #: prefetch thread), the wall time between consecutive steps, and
        #: checkpoint writes and reads as (step, bytes, seconds)
        self.timings = dict(sup_caps_s=None, place_s=[], step_s=[], ckpt_write=[],
                            ckpt_read=[])
        self._ckpt_root = None
        if cfg.checkpoint_dir:
            self._ckpt_root = pathlib.Path(cfg.checkpoint_dir).absolute()
            self._ckpt_root.mkdir(parents=True, exist_ok=True)

    # -- the captured steps -------------------------------------------------

    def _chain_step(self, kind: str, feats, den, sup, *dropout) -> dict:
        """One captured step of `kind` ("plain", "dropout", "backstitch"):
        the graph for the plan of its optimizer calls and the batch's
        shape, then the chain's host counters."""
        cfg, opt = self.cfg, self.state.optimizer
        plan = opt.plan(2 if kind == "backstitch" else 1)
        key = (kind, plan, shape_key(feats, sup))
        step = self._steps.get(key)
        if step is None:
            def update(i, scale, plan=plan):
                opt.apply(plan[i], scale)

            kw = dict(use_xent=cfg.use_xent, mesh=self.dp, capture=True, update=update,
                      pool=self._pool)
            if kind == "backstitch":
                step = make_backstitch_step(self.state, cfg.loss, cfg.backstitch_scale, **kw)
            else:
                step = make_train_step(self.state, cfg.loss, max_grad_norm=0.0,
                                       dropout=kind == "dropout", **kw)
            self._steps[key] = step
        metrics = step(feats, den, sup, *dropout)
        opt.advance(plan)
        return metrics

    def _semi_orthogonal(self) -> None:
        """The constraint on every `linear_pre`, in place: under capture one
        graph of its own (where the model has such a parameter), outside
        the steps' (the JAX Trainer calls it between its jitted steps too)."""
        if self.cfg.capture and self._ortho is None and constrained_parameters(self.model):
            self._ortho = CapturedCall(self.state, lambda: constrain_semi_orthogonal(self.model),
                                       self._pool)
        if self._ortho is not None:
            self._ortho()
        else:
            constrain_semi_orthogonal(self.model)

    @property
    def graphs(self) -> dict:
        """The captured graphs: each step's by (kind, plan, batch shape),
        "semi_orthogonal", and `evaluate`'s by (model, batch shape)."""
        out = {k: v for k, v in self._steps.items() if isinstance(v, CapturedStep)}
        if self._ortho is not None:
            out["semi_orthogonal"] = self._ortho
        out.update(getattr(getattr(self, "_eval_step", None), "graphs", {}))
        return out

    # -- placement --------------------------------------------------------

    def _place(self, batch: ChainBatch, shapes=(None, None)):
        """The batch on the device, its live-arc lists `shapes[0]` wide and
        a flat-start vocabulary `shapes[1]` wide where given."""
        L_cap, vocab_cap = shapes
        if isinstance(batch.sup, E2eSupervision):
            sup = DeviceE2eSupervision.from_host(batch.sup, device=self.device,
                                                 vocab_cap=vocab_cap)
        else:
            sup = DeviceSupervision.from_host(batch.sup, device=self.device)
        return torch.as_tensor(batch.feats).to(self.device), sup.with_kernel_tables(L_cap=L_cap)

    def _put_batch(self, batch: ChainBatch, shapes=(None, None)):
        """(feats, sup, event): the batch on the device (`_place`).  On a
        CUDA device the copies and the kernel tables' sizing (which reads
        one number back) run on the side stream, so they wait for nothing
        the step has queued; `event` marks their end (None elsewhere).  A
        PlacedBatch (MaterializedBatches(..., device=...)) is already there:
        it passes through with no copy and no event."""
        if isinstance(batch, PlacedBatch):
            return batch.feats, batch.sup, None
        if self._stream is None:
            return (*self._place(batch, shapes), None)
        with torch.cuda.stream(self._stream):
            feats, sup = self._place(batch, shapes)
            event = torch.cuda.Event()
            event.record(self._stream)
        return feats, sup, event

    def _ready(self, placed):
        """The step's side of `_put_batch`: its stream waits on the event,
        and the caching allocator learns that the tensors are used there."""
        feats, sup, event = placed
        if event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(event)
            for t in [feats, *_tensors(sup)]:
                t.record_stream(stream)
        return feats, sup

    # -- checkpointing ----------------------------------------------------

    def _run_config_path(self) -> pathlib.Path:
        return pathlib.Path(self.cfg.checkpoint_dir).absolute() / "run_config.json"

    def save_run_config(self):
        """Serialize the run config and the den/tree fingerprints next to
        the checkpoints; resume verifies them."""
        payload = dict(config=_config_to_jsonable(self.cfg), fingerprints=self.fingerprints)
        self._run_config_path().write_text(json.dumps(payload, indent=2))

    @staticmethod
    def load_run_config(checkpoint_dir: str) -> dict | None:
        p = pathlib.Path(checkpoint_dir).absolute() / "run_config.json"
        if not p.exists():
            return None
        return json.loads(p.read_text())

    def all_steps(self) -> list[int]:
        """The steps of the checkpoints on disk, oldest first."""
        if self._ckpt_root is None:
            return []
        return sorted(int(p.name) for p in self._ckpt_root.iterdir()
                      if p.name.isdigit() and (p / _CKPT_FILE).exists())

    def save_checkpoint(self):
        """Write the train state (global rank 0 writes; every rank waits
        for it)."""
        if self._ckpt_root is None:
            return
        if self.mesh.data * self.mesh.model > 1:
            if self.mesh.global_rank == 0:
                self._write_checkpoint()
            barrier(self.mesh)
            return
        self._write_checkpoint()

    def _write_checkpoint(self):
        if not self._run_config_path().exists():
            self.save_run_config()
        step = int(self.state.step)
        payload = dict(
            model=self.model.state_dict(),
            optimizer=self.state.optimizer.state_dict(),
            step=step,
            epoch=self.current_epoch,
            batch_in_epoch=self.batch_in_epoch,
        )
        t0 = time.perf_counter()
        final = self._ckpt_root / str(step)
        tmp = self._ckpt_root / f".{step}.tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir()
        torch.save(payload, tmp / _CKPT_FILE)
        shutil.rmtree(final, ignore_errors=True)
        tmp.rename(final)
        for old in self.all_steps()[:-KEEP_CHECKPOINTS]:
            shutil.rmtree(self._ckpt_root / str(old))
        self.timings["ckpt_write"].append(
            (step, (final / _CKPT_FILE).stat().st_size, time.perf_counter() - t0))

    def _load(self, step: int) -> dict:
        path = self._ckpt_root / str(step) / _CKPT_FILE
        t0 = time.perf_counter()
        payload = torch.load(path, map_location=self.device, weights_only=True)
        self.timings["ckpt_read"].append((step, path.stat().st_size, time.perf_counter() - t0))
        return payload

    def restore_checkpoint(self) -> bool:
        steps = self.all_steps()
        if not steps:
            return False
        saved = self.load_run_config(self.cfg.checkpoint_dir)
        if saved is not None:
            for key in ("den", "tree"):
                old = saved.get("fingerprints", {}).get(key)
                new = self.fingerprints.get(key)
                if old is not None and new is not None and old != new:
                    raise ValueError(
                        f"refusing to resume: {key} fingerprint changed "
                        f"({old} -> {new}); the checkpoint was trained "
                        "against a different graph/tree — restart from "
                        "scratch or restore the original data prep"
                    )
        payload = self._load(steps[-1])
        self.model.load_state_dict(payload["model"])
        self.state.optimizer.load_state_dict(payload["optimizer"])
        self.state.step = int(payload["step"])
        # exact resume: same epoch, skipping already-consumed batches —
        # shuffling is a pure function of (seed, epoch), so the skipped
        # prefix is identical to the original run's
        self.start_epoch = int(payload["epoch"])
        self.skip_batches = int(payload["batch_in_epoch"])
        self.current_epoch = self.start_epoch
        return True

    # -- main loop --------------------------------------------------------

    def _flush_metrics(self, pending: list) -> dict | None:
        """Read the buffered device metrics back in one transfer, feed
        ChainResults, and return the last step's host dict."""
        if not pending:
            return None
        keys = list(pending[0][2])
        host_all = torch.stack(
            [torch.stack([m[k].float() for k in keys]) for _, _, m in pending]
        ).cpu().numpy()
        last = None
        for (step, epoch, _), row in zip(pending, host_all):
            host = {k: float(v) for k, v in zip(keys, row)}
            self.results.add(host)
            last = (step, epoch, host)
        pending.clear()
        step, epoch, host = last
        host["step"] = step
        host["epoch"] = epoch
        return host

    def _batches(self, dataset, epoch: int):
        """(this rank's batches of the epoch, whether the ranks must agree
        on when it ends).  Under data parallelism `batch_size` is the global
        batch: a dataset that takes process_index/process_count (ChainDataset,
        CegsDataset) gives this rank its rows of every global batch, equal in
        count on every rank; MaterializedBatches must have been materialized
        with them; any other dataset (E2eChainDataset) is taken as this
        rank's own utterances, batched at batch_size / data, and every rank
        stops when the first runs out."""
        threads = self.cfg.loader_threads
        kw = dict(epoch=epoch,
                  num_threads=default_loader_threads() if threads is None else threads)
        if self._sup_caps is not None:
            kw["sup_caps"] = self._sup_caps
        mesh = self.dp
        if mesh is None:
            return dataset.batches(self.cfg.batch_size, **kw), False
        if isinstance(dataset, MaterializedBatches):
            if dataset.process_count != mesh.data:
                raise ValueError(
                    f"MaterializedBatches of {dataset.process_count} process(es) under a data "
                    f"axis of {mesh.data}: materialize each rank's rows with "
                    "process_index=rank, process_count=world")
            return dataset.batches(self.cfg.batch_size, **kw), False
        if "process_index" in inspect.signature(dataset.batches).parameters:
            return dataset.batches(self.cfg.batch_size, process_index=mesh.rank,
                                   process_count=mesh.data, **kw), False
        if self.cfg.batch_size % mesh.data:
            raise ValueError(f"global batch {self.cfg.batch_size} not divisible by the data "
                             f"axis {mesh.data}")
        return dataset.batches(self.cfg.batch_size // mesh.data, **kw), True

    def _stop_together(self, batches, agree: bool):
        """`batches` until it ends; with `agree`, until it ends on any rank
        (one host all-reduce a batch, on this thread)."""
        for item in batches:
            if agree and host_min(self.dp, 1) == 0:
                return
            yield item
        if agree:
            host_min(self.dp, 0)

    def fit(self, dataset, log_fn=print, max_steps: int = 0) -> ChainResults:
        """Train for the configured epochs (from the restored position),
        or until the step count reaches `max_steps` (0 = no limit)."""
        cfg = self.cfg
        t_start = time.time()
        frames_done = 0
        step = int(self.state.step)
        pending: list = []
        self.model.train()
        done = bool(max_steps) and step >= max_steps
        for epoch in range(self.start_epoch, cfg.num_epochs):
            if done:
                break
            self.current_epoch = epoch
            self.batch_in_epoch = 0
            if cfg.frame_shift_cycle and hasattr(dataset, "frame_shift"):
                # Kaldi frame-shift augmentation (nnet3-chain-copy-egs
                # --frame-shift=epoch%fsf): deterministic in epoch, so a
                # mid-epoch resume reproduces it
                dataset.frame_shift = epoch % dataset.fsf
            # one fixed supervision padding for the whole run
            if self._sup_caps is None and (cfg.capture or hasattr(dataset, "estimate_sup_caps")):
                t0 = time.perf_counter()
                if cfg.capture:
                    self._sup_caps, self._shapes = self._shapes_of(dataset)
                else:
                    self._sup_caps = dataset.estimate_sup_caps()
                if self.dp is not None:
                    # one padding on every rank: rank 0's
                    self._sup_caps, self._shapes = broadcast_object(
                        self.dp, (self._sup_caps, self._shapes))
                self.timings["sup_caps_s"] = time.perf_counter() - t0

            def _put_iter(it, skip_until: int):
                # placement runs on the prefetch thread, beside the step
                for i, b in enumerate(it):
                    if i < skip_until:
                        yield b, None
                        continue
                    t0 = time.perf_counter()
                    placed = self._put_batch(b, self._shapes)
                    self.timings["place_s"].append(time.perf_counter() - t0)
                    yield b, placed

            skip_until = self.skip_batches if epoch == self.start_epoch else 0
            batches, agree = self._batches(dataset, epoch)
            prefetch = Prefetcher(_put_iter(batches, skip_until))
            for bi, (batch, placed) in enumerate(self._stop_together(prefetch, agree)):
                if placed is None:
                    continue
                self.batch_in_epoch = bi + 1
                feats, sup = self._ready(placed)
                if self._dropout_fn is not None:
                    # progress = fraction of training data processed; the
                    # within-epoch fraction needs the epoch's batch count,
                    # known after the first epoch
                    frac = bi / self._batches_per_epoch if self._batches_per_epoch else 0.0
                    progress = (epoch + frac) / max(cfg.num_epochs, 1)
                    self._dropout_gen.manual_seed(step)
                    metrics = self.train_step(feats, self.den, sup,
                                              self._dropout_fn(progress), self._dropout_gen)
                elif self.backstitch_step is not None and (
                    step % max(cfg.backstitch_interval, 1) == 0
                ):
                    metrics = self.backstitch_step(feats, self.den, sup)
                else:
                    metrics = self.train_step(feats, self.den, sup)
                step += 1
                if cfg.semi_ortho_every and step % cfg.semi_ortho_every == 0:
                    self._semi_orthogonal()
                self.timings["step_s"].append(time.perf_counter())
                pending.append((step, epoch, metrics))
                frames_done += batch.feats.shape[0] * batch.sup.num_frames * self.mesh.data
                if step % cfg.log_every == 0:
                    host = self._flush_metrics(pending)
                    host["wall_s"] = time.time() - t_start
                    host["frames_per_s"] = frames_done / host["wall_s"]
                    self.metrics_log.append(host)
                    log_fn(
                        f"step {step} epoch {epoch}: "
                        f"objf={host['objf']:.4f} loss={host['loss']:.4f} "
                        f"grad={host['grad_norm']:.3f}"
                    )
                if self._ckpt_root is not None and step % cfg.checkpoint_every == 0:
                    self.save_checkpoint()
                if max_steps and step >= max_steps:
                    done = True
                    break
            prefetch.close()
            if self._batches_per_epoch is None and self.batch_in_epoch and not done:
                self._batches_per_epoch = self.batch_in_epoch
        if hasattr(dataset, "frame_shift"):
            dataset.frame_shift = 0  # leave the loader eval-clean
        self._flush_metrics(pending)
        if self._ckpt_root is not None:
            self.save_checkpoint()
        return self.results

    def begin_stage(self) -> None:
        """Start a new stage of training on another dataset (the flat-start
        ladder's tolerance-lattice stage after its e2e stage): the next
        `fit` counts its epochs from 0 again and re-estimates the
        supervision padding; the model, the optimizer and the step count
        carry on."""
        self.start_epoch = 0
        self.current_epoch = 0
        self.batch_in_epoch = 0
        self.skip_batches = 0
        self._sup_caps = None
        self._shapes = (None, None)
        self._batches_per_epoch = None

    @staticmethod
    def _shapes_of(dataset):
        """(sup_caps, (L_cap, vocab_cap)) that give every batch of
        `dataset` one shape, as capture needs: flat-start
        `estimate_e2e_caps`, else `estimate_sup_caps` and
        `estimate_live_arcs`.  A dataset with neither raises ValueError:
        each of its batches would capture a graph of its own."""
        if hasattr(dataset, "estimate_e2e_caps"):
            caps = dataset.estimate_e2e_caps()
            return caps, (caps[3], caps[2])
        for name in ("estimate_sup_caps", "estimate_live_arcs"):
            if not hasattr(dataset, name):
                raise ValueError(f"capture=True: {type(dataset).__name__} has no {name}, so"
                                 " its batches have no one shape (each would capture a graph"
                                 " of its own)")
        return dataset.estimate_sup_caps(), (dataset.estimate_live_arcs(), None)

    def step_ms(self) -> float | None:
        """Median host wall ms between consecutive steps of the last fit
        (None under two steps)."""
        t = self.timings["step_s"]
        if len(t) < 3:
            return None
        return float(statistics.median(np.diff(t)[1:])) * 1e3

    def combine(self, last_n: int = 3) -> int:
        """Kaldi's 'combine' stage as checkpoint averaging: the parameters
        of the last `last_n` checkpoints, averaged uniformly, replace the
        live model's (batchnorm statistics stay).  Returns the number of
        checkpoints combined."""
        steps = self.all_steps()[-max(1, last_n):]
        if len(steps) < 2:
            return len(steps)
        names = [n for n, _ in self.model.named_parameters()]
        acc = None
        for s in steps:
            sd = self._load(s)["model"]
            p = [sd[n].float() for n in names]
            acc = p if acc is None else [a + b for a, b in zip(acc, p)]
        with torch.no_grad():
            for (_, param), a in zip(self.model.named_parameters(), acc):
                param.copy_(a / len(steps))
        return len(steps)

    def evaluate(self, dataset, max_batches: int = 0) -> ChainResults:
        """Validation pass (nnet3-chain-compute-prob): objf over a held-out
        dataset, no parameter updates; the batches' statistics stay on the
        device and are read once, at the end.  Under data parallelism every
        rank reads the same global batches and scores its rows of each (the
        sums all-reduced: every rank gets the global statistics); a batch
        the data axis does not divide is scored whole on every rank.  With
        `capture` the batches are padded to one shape a pass
        (`_shapes_of(dataset)`; the last, smaller batch has its own), and
        each shape replays its own graph."""
        cfg = self.cfg
        if not hasattr(self, "_eval_step"):
            self._eval_step = make_eval_step(cfg.loss, use_xent=cfg.use_xent,
                                             capture=cfg.capture, pool=self._pool)
            self._eval_step_dp = make_eval_step(cfg.loss, use_xent=cfg.use_xent, mesh=self.dp)
        kw, shapes = {}, (None, None)
        if cfg.capture:
            kw["sup_caps"], shapes = self._shapes_of(dataset)
        pending = []
        for i, batch in enumerate(
            dataset.batches(cfg.batch_size, shuffle=False, drop_last=False, **kw)
        ):
            if max_batches and i >= max_batches:
                break
            step = self._eval_step
            if shardable(self.dp, batch.feats.shape[0]):
                batch, step = shard_batch(self.dp, batch), self._eval_step_dp
            feats, sup = self._ready(self._put_batch(batch, shapes))
            pending.append(step(self.model, feats, self.den, sup))
        results = ChainResults()
        if pending:
            keys = list(pending[0])
            rows = torch.stack([torch.stack([a[k].float() for k in keys])
                                for a in pending]).cpu().numpy()
            for row in rows:
                results.add({k: float(v) for k, v in zip(keys, row)})
        return results

    def dump_metrics(self, path: str):
        with open(path, "w") as f:
            for m in self.metrics_log:
                f.write(json.dumps(m) + "\n")

