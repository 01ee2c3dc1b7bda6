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
from torchain_tpu_torch.models.semi_orthogonal import constrain_semi_orthogonal
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
from torchain_tpu_torch.parallel.sharding import squared_norms
from torchain_tpu_torch.train.lowmem_adam import LowmemAdam
from torchain_tpu_torch.train.ngsgd import NGSGD
from torchain_tpu_torch.train.state import ChainTrainState
from torchain_tpu_torch.train.step import (
    clip_by_global_norm_,
    global_norm,
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


def lr_schedule(cfg: TrainerConfig):
    """count -> learning rate: optax.exponential_decay(lr, lr_decay_steps,
    lr_final / lr, end_value=lr_final) where both are set, else constant;
    evaluated in float32 at the count of updates made before this one, as
    optax's scale_by_schedule does."""
    if not (cfg.lr_final > 0.0 and cfg.lr_decay_steps > 0):
        return lambda count: cfg.lr
    lr, rate = np.float32(cfg.lr), np.float32(cfg.lr_final / cfg.lr)
    steps, end = np.float32(cfg.lr_decay_steps), np.float32(cfg.lr_final)

    def schedule(count: int) -> float:
        if count <= 0:
            return float(lr)
        value = lr * np.power(rate, np.float32(count) / steps)
        return float(max(value, end) if rate < 1 else min(value, end))

    return schedule


def max_change(per_component: float = 0.75, global_change: float = 2.0):
    """Kaldi max-change update clipping (every chain recipe trains with
    per-component max-change 0.75 and --trainer.max-param-change 2.0):
    each component's parameter DELTA (post-LR) is rescaled to 2-norm <=
    per_component, then the whole update so that its global 2-norm <=
    global_change.  Unlike gradient clipping this bounds the parameters'
    actual motion per step.  Returns updates -> updates over a list of
    tensors (the last transform of the optimizer chain)."""

    def apply(updates: list[torch.Tensor], params=None) -> list[torch.Tensor]:
        # `params`: the updates' parameters, where leaves sharded over the
        # model axis take their norms over the model group
        if per_component > 0:
            norms = [torch.sqrt(sq) for sq in squared_norms(updates, params)]
            updates = [u * torch.clamp(per_component / torch.clamp(n, min=1e-30), max=1.0)
                       for u, n in zip(updates, norms)]
        if global_change > 0:
            g = global_norm(updates, params)
            scale = torch.clamp(global_change / torch.clamp(g, min=1e-30), max=1.0)
            updates = [u * scale for u in updates]
        return updates

    return apply


class ChainOptimizer:
    """The JAX package's optax chain over torch.optim:
    MultiSteps(k)( clip_by_global_norm -> adam | adam-lowmem |
    sgd(momentum) | natural_gradient -> sgd(momentum) at `lr_schedule` ->
    max_change ).  The inner optimizers are torch.optim.Adam and SGD,
    `train.lowmem_adam.LowmemAdam` and `train.ngsgd.NGSGD`.

    `step(scale)` consumes the parameters' .grad.  With k > 1 the gradient
    is folded into a running mean (optax's Welford form) and the inner
    update runs on every k-th call only, on the mean; the schedule's count
    advances once per inner update.  Max-change (and the backstitch
    `scale`) act on the update the inner optimizer made, taken as
    p_new - p_old around its step."""

    def __init__(self, params, cfg: TrainerConfig):
        self.params = [p for p in params if p.requires_grad]
        if cfg.optimizer == "adam":
            self.inner = torch.optim.Adam(self.params, lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8)
        elif cfg.optimizer == "adam-lowmem":
            self.inner = LowmemAdam(self.params, lr=cfg.lr)
        elif cfg.optimizer == "sgd":
            self.inner = torch.optim.SGD(self.params, lr=cfg.lr, momentum=cfg.momentum)
        elif cfg.optimizer == "ngsgd":
            self.inner = NGSGD(self.params, lr=cfg.lr, momentum=cfg.momentum)
        else:
            raise ValueError(f"optimizer {cfg.optimizer!r} is not ported (the optimizers are:"
                             " adam, adam-lowmem, sgd, ngsgd)")
        self.schedule = lr_schedule(cfg)
        self.grad_clip = cfg.grad_clip
        self.every = max(1, cfg.grad_accum_steps)
        self.max_change = (
            max_change(cfg.max_change_per_component, cfg.max_param_change)
            if cfg.max_change_per_component > 0 or cfg.max_param_change > 0 else None)
        self.count = 0  # inner updates made
        self.mini_step = 0
        self.acc: list[torch.Tensor] | None = None

    @torch.no_grad()
    def step(self, scale: float = 1.0) -> bool:
        """Apply the gradients; returns whether the parameters moved."""
        grads = [p.grad for p in self.params]
        if self.every > 1:
            if self.acc is None:
                self.acc = [torch.zeros_like(g) for g in grads]
            n = self.mini_step
            for a, g in zip(self.acc, grads):
                a.add_((g - a) / (n + 1))
            self.mini_step = (n + 1) % self.every
            if n != self.every - 1:
                return False
            for g, a in zip(grads, self.acc):
                g.copy_(a)
                a.zero_()
        if self.grad_clip > 0:
            clip_by_global_norm_(grads, self.grad_clip, self.params)
        for group in self.inner.param_groups:
            group["lr"] = self.schedule(self.count)
        moved = self.max_change is not None or scale != 1.0
        old = [p.detach().clone() for p in self.params] if moved else None
        self.inner.step()
        self.count += 1
        if moved:
            deltas = [p - o for p, o in zip(self.params, old)]
            if self.max_change is not None:
                deltas = self.max_change(deltas, self.params)
            for p, o, d in zip(self.params, old, deltas):
                p.copy_(o + scale * d)
        return True

    def state_dict(self) -> dict:
        return dict(inner=self.inner.state_dict(), count=self.count, mini_step=self.mini_step,
                    acc=self.acc)

    def load_state_dict(self, state: dict) -> None:
        self.inner.load_state_dict(state["inner"])
        self.count, self.mini_step = int(state["count"]), int(state["mini_step"])
        self.acc = state["acc"]


def make_optimizer(cfg: TrainerConfig, params) -> ChainOptimizer:
    return ChainOptimizer(params, cfg)


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
    ContextTree), where given, is fingerprinted into the checkpoints."""

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
        # the optimizer clips (after accumulation): the step does not.  Under
        # data parallelism the step all-reduces every micro-batch's gradient,
        # so each micro-step's grad_norm is the global gradient's
        self.train_step = make_train_step(self.state, cfg.loss, use_xent=cfg.use_xent,
                                          max_grad_norm=0.0,
                                          dropout=self._dropout_fn is not None, mesh=self.dp)
        self.backstitch_step = None
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

    # -- placement --------------------------------------------------------

    def _place(self, batch: ChainBatch):
        if isinstance(batch.sup, E2eSupervision):
            sup = DeviceE2eSupervision.from_host(batch.sup, device=self.device)
        else:
            sup = DeviceSupervision.from_host(batch.sup, device=self.device)
        return torch.as_tensor(batch.feats).to(self.device), sup.with_kernel_tables()

    def _put_batch(self, batch: ChainBatch):
        """(feats, sup, event): the batch on the device.  On a CUDA device
        the copies and the kernel tables' sizing (which reads one number
        back) run on the side stream, so they wait for nothing the step
        has queued; `event` marks their end (None elsewhere).  A
        PlacedBatch (MaterializedBatches(..., device=...)) is already there:
        it passes through with no copy and no event."""
        if isinstance(batch, PlacedBatch):
            return batch.feats, batch.sup, None
        if self._stream is None:
            return (*self._place(batch), None)
        with torch.cuda.stream(self._stream):
            feats, sup = self._place(batch)
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
            if self._sup_caps is None and hasattr(dataset, "estimate_sup_caps"):
                t0 = time.perf_counter()
                self._sup_caps = dataset.estimate_sup_caps()
                if self.dp is not None:
                    # one padding on every rank: rank 0's
                    self._sup_caps = broadcast_object(self.dp, self._sup_caps)
                self.timings["sup_caps_s"] = time.perf_counter() - t0

            def _put_iter(it, skip_until: int):
                # placement runs on the prefetch thread, beside the step
                for i, b in enumerate(it):
                    if i < skip_until:
                        yield b, None
                        continue
                    t0 = time.perf_counter()
                    placed = self._put_batch(b)
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
                    constrain_semi_orthogonal(self.model)
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
        self._batches_per_epoch = None

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
        dataset, no parameter updates.  Under data parallelism every rank
        reads the same global batches and scores its rows of each (the sums
        all-reduced: every rank gets the global statistics); a batch the
        data axis does not divide is scored whole on every rank."""
        if not hasattr(self, "_eval_step"):
            self._eval_step = make_eval_step(self.cfg.loss, use_xent=self.cfg.use_xent)
            self._eval_step_dp = make_eval_step(self.cfg.loss, use_xent=self.cfg.use_xent,
                                                mesh=self.dp)
        results = ChainResults()
        for i, batch in enumerate(
            dataset.batches(self.cfg.batch_size, shuffle=False, drop_last=False)
        ):
            if max_batches and i >= max_batches:
                break
            step = self._eval_step
            if shardable(self.dp, batch.feats.shape[0]):
                batch, step = shard_batch(self.dp, batch), self._eval_step_dp
            feats, sup = self._ready(self._put_batch(batch))
            aux = step(self.model, feats, self.den, sup)
            results.add({k: float(v) for k, v in aux.items()})
        return results

    def dump_metrics(self, path: str):
        with open(path, "w") as f:
            for m in self.metrics_log:
                f.write(json.dumps(m) + "\n")

