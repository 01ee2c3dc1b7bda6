"""One rank of a data- or model-parallel run, port of tools/multihost_worker.py.

    python -m torchain_tpu_torch.tools.multihost_worker RANK WORLD MODE \\
        --init file:///tmp/store [--device cpu] [--backend gloo] [--config JSON]

Each rank joins the process group through `parallel.init_distributed` (an
explicit backend and a `file://` store: no port to race for; WORLD 1 joins
none and runs the one-process path) and prints one line
`MULTIHOST_RESULT {json}`.  Modes:

  loss     one global batch of 4 rows from `ChainDataset.batches`
           (process_index/process_count), y = tanh(features @ a fixed
           projection), `chain_loss(..., mesh=)` and its backward: the loss,
           objf and the L1 and squared sums of dL/dy over the global batch;
  trainer  `Trainer.fit` of a TDNN-F (or the conformer) over a ChainDataset,
           `batch_size` the global batch, on config["mesh"] (a model axis
           too: the state replicated, as in the JAX `Trainer`): the curve
           (objf, loss, grad_norm, weight a step), the step count, the
           total weight, ms between steps, the collectives a step by
           group, the kernel launches (config["counters"]), and the state
           dict after the run with the
           first step's gradients (after the optimizer's clip) written to
           config["save_params"] (rank 0); with config["evaluate"], then
           `Trainer.evaluate` over the same dataset;
  cegs     `Trainer.fit` straight off a merged cegs archive (4 records of 2
           sequences; `CegsDataset` deals records round-robin to the ranks);
  bn       the fused batchnorm, its relu/bypass form and the stock (flax)
           batchnorm on this rank's rows of one global input, forward and
           backward inside `parallel.data_parallel`: the gathered outputs
           and input gradients, the summed parameter gradients and the
           running statistics, written to config["out"] (rank 0);
  model    the sharded step on a (data, model) mesh (config["mesh"]):
           one global batch of config["batch_size"] rows (each data rank
           its rows), the model built from config["model_seed"] (or
           config["weights"]) and sharded by `parallel.shard_params` at
           config["min_shard_size"], then config["steps"] steps of
           `make_train_step` with `ChainOptimizer` (config["trainer"]):
           each step's loss, objf and gradient norm, the parameters after
           the run gathered whole (written to config["save_params"] by
           global rank 0, with the first step's gradients, gathered), each
           rank's parameter and optimizer-state bytes, the collectives a
           step by group (`Mesh.stats`), ms between steps, the kernel
           launches and the sharded leaves.  config["variants"], a list of
           overrides of these keys, runs each in turn on the same batch
           (one result each; save_params gets the variant's index).

`spawn(world, mode, config, workdir)` starts the ranks, each with a
timeout, and returns their results; tests/test_torch_multihost.py,
tests/test_torch_parallel.py and chip_smoke.py use it.  `run(...)` runs
one rank in the calling process (WORLD 1: the reference).
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

REPO = pathlib.Path(__file__).resolve().parents[2]
RESULT = "MULTIHOST_RESULT "

#: the corpus, data and model of the JAX worker (tools/multihost_worker.py)
DEFAULTS = dict(
    corpus=dict(num_utts=12, num_phones=5, feat_dim=8, seed=7),
    chunk_frames=16,
    sup_opts=dict(frame_subsampling_factor=3),
    data_seed=3,
    model="tdnnf",
    model_cfg=dict(hidden_dim=32, bottleneck_dim=8, prefinal_dim=16, num_layers=2),
    model_seed=0,
    weights=None,
    batch_size=4,
    epochs=1,
    steps=0,
    trainer=dict(lr=1e-3, log_every=1, semi_ortho_every=0),
    loss=dict(leaky_hmm_coefficient=0.1),
    precompile=0,
    counters={},
    save_params=None,
    checkpoint_dir=None,
    restore=False,
    evaluate=False,
    mesh=dict(data=-1, model=1),
    min_shard_size=2**18,
    den="auto",
    variants=None,
)


def _corpus_and_dataset(c: dict, context):
    from torchain_tpu_torch.data import ChainDataset, synthetic_dataset
    from torchain_tpu_torch.graphs import SupervisionOptions

    kw = dict(c["corpus"])
    if "utt_frames_out" in kw:
        kw["utt_frames_out"] = tuple(kw["utt_frames_out"])
    corpus = synthetic_dataset(**kw)
    left, right = context
    ds = ChainDataset(corpus.utts, corpus.tree, corpus.norm_fst,
                      chunk_frames_out=c["chunk_frames"], left_context=left,
                      right_context=right, sup_opts=SupervisionOptions(**c["sup_opts"]),
                      seed=c["data_seed"])
    if c["precompile"]:
        ds.precompile(num_workers=c["precompile"])
    return corpus, ds


def _config(c: dict, num_pdfs: int = 1):
    """(model class, its config) from config["model"] (tdnnf, conformer,
    tdnn, tdnn-lstm or cnn-tdnn) and ["model_cfg"]."""
    from torchain_tpu_torch import models

    kw = dict(c["model_cfg"])
    if "dtype" in kw:
        kw["dtype"] = getattr(torch, kw["dtype"])
    cls, cfg_cls = {
        "tdnnf": (models.TDNNF, models.TdnnfConfig),
        "conformer": (models.Conformer, models.ConformerConfig),
        "tdnn": (models.TDNN, models.TdnnConfig),
        "tdnn-lstm": (models.TDNNLSTM, models.TdnnLstmConfig),
        "cnn-tdnn": (models.CNNTDNN, models.CnnTdnnConfig),
    }[c["model"]]
    return cls, cfg_cls(num_pdfs=num_pdfs, **kw)


def _model(c: dict, num_pdfs: int, feat_dim: int, device):
    """The model, its weights drawn from config["model_seed"] or read from
    config["weights"] (a state dict)."""
    cls, cfg = _config(c, num_pdfs)
    model = cls(cfg, feat_dim, device=device,
                generator=torch.Generator().manual_seed(c["model_seed"]))
    if c["weights"]:
        model.load_state_dict(torch.load(c["weights"], map_location=device, weights_only=True))
    return model


def _counters(c: dict) -> dict:
    """The kernel wrappers config["counters"] names ("module:function"
    under torchain_tpu_torch), by kernel name."""
    out = {}
    for name, where in c["counters"].items():
        mod, fn = where.split(":")
        out[name] = getattr(importlib.import_module(f"torchain_tpu_torch.{mod}"), fn)
    return out


def _trainer_config(c: dict, device, **kw):
    from torchain_tpu_torch.ops import ChainLossOptions
    from torchain_tpu_torch.parallel import MeshConfig
    from torchain_tpu_torch.train import TrainerConfig

    return TrainerConfig(**{**dict(batch_size=c["batch_size"], num_epochs=c["epochs"],
                                   loss=ChainLossOptions(**c["loss"]), device=str(device),
                                   checkpoint_dir=c["checkpoint_dir"],
                                   mesh=MeshConfig(**c["mesh"])),
                            **c["trainer"], **kw})


def _curve(trainer) -> list[dict]:
    keys = ("step", "objf", "loss", "grad_norm", "weight", "num_failed")
    return [{k: m[k] for k in keys} for m in trainer.metrics_log]


def trainer_mode(c: dict, device, rank: int) -> dict:
    from torchain_tpu_torch.ops import auto_den_graph
    from torchain_tpu_torch.train import Trainer

    corpus, ds = _corpus_and_dataset(c, _config(c)[1].context)
    model = _model(c, corpus.tree.num_pdfs, corpus.feat_dim, device)
    den = auto_den_graph(corpus.den_graph, device=device)
    trainer = Trainer(model, den, _trainer_config(c, device), tree=corpus.tree)
    if c["restore"]:
        trainer.restore_checkpoint()
    counters = _counters(c)
    for fn in counters.values():
        fn.launches = 0
    first_grads = {}
    step = trainer.train_step

    def keep_first(*a, **k):
        out = step(*a, **k)
        if not first_grads:
            first_grads.update({n: p.grad.detach().cpu().clone()
                                for n, p in trainer.model.named_parameters()
                                if p.grad is not None})
        return out

    trainer.train_step = keep_first
    stats = trainer.mesh.stats
    before = {axis: dict(v) for axis, v in stats.items()}
    results = trainer.fit(ds, log_fn=lambda s: None, max_steps=c["steps"])
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    steps = max(len(trainer.metrics_log), 1)
    per_step = {axis: {k: (stats[axis][k] - before[axis][k]) / steps for k in v}
                for axis, v in before.items()}
    if c["save_params"] and rank == 0:
        torch.save(dict(params={k: v.detach().cpu()
                                for k, v in trainer.model.state_dict().items()},
                        first_grads=first_grads), c["save_params"])
    evaluated = None
    if c["evaluate"]:
        ev = trainer.evaluate(ds)
        evaluated = dict(objf=ev.objf, weight=ev.tot_weight, batches=ev.steps)
    return dict(objf=results.objf, steps=results.steps, failed=results.tot_failed,
                weight=results.tot_weight, curve=_curve(trainer), step_ms=trainer.step_ms(),
                evaluated=evaluated,
                collectives_per_step=per_step,
                launches={k: fn.launches for k, fn in counters.items()},
                parameters=sum(p.numel() for p in trainer.model.parameters()))


def loss_mode(c: dict, device, mesh) -> dict:
    from torchain_tpu_torch.ops import DeviceSupervision, auto_den_graph, chain_loss

    corpus, ds = _corpus_and_dataset(dict(c, chunk_frames=16), (4, 4))
    caps = ds.estimate_sup_caps()
    den = auto_den_graph(corpus.den_graph, device=device)
    multi = mesh.data > 1
    batch = next(ds.batches(4, epoch=0, process_index=mesh.rank if multi else None,
                            process_count=mesh.data if multi else None, sup_caps=caps))
    # a deterministic y from the features (no model, no random state)
    rng = np.random.default_rng(11)
    proj = rng.normal(size=(8, corpus.tree.num_pdfs)).astype(np.float32) * 0.3
    t_out = batch.sup.num_frames
    f_local = batch.feats[:, 4: 4 + t_out * 3: 3, :]
    y = torch.tensor(np.tanh(f_local @ proj), device=device, requires_grad=True)
    sup = DeviceSupervision.from_host(batch.sup, device=device).with_kernel_tables()
    loss, aux = chain_loss(y, None, den, sup, mesh=mesh if multi else None)
    loss.backward()
    sums = torch.stack([y.grad.abs().sum(), torch.square(y.grad).sum()]).double()
    if multi:
        from torchain_tpu_torch.parallel.mesh import all_reduce_

        all_reduce_(mesh, sums)
    return dict(loss=float(loss.detach()), objf=float(aux["objf"]), weight=float(aux["weight"]),
                grad_l1=float(sums[0]), grad_sq=float(sums[1]))


def cegs_mode(c: dict, device, rank: int, workdir: str) -> dict:
    """Training straight off a merged cegs archive, as the JAX worker's
    cegs mode: 48-frame utterances (every chunk 16 output frames), merged
    records of 2 sequences, 2 epochs."""
    from torchain_tpu_torch.data.cegs import CegsDataset, dataset_to_cegs
    from torchain_tpu_torch.ops import auto_den_graph
    from torchain_tpu_torch.train import Trainer

    c = dict(c, corpus=dict(c["corpus"], utt_frames_out=(48, 49)))
    corpus, ds = _corpus_and_dataset(c, _config(c)[1].context)
    path = os.path.join(workdir, f"cegs_{rank}_{os.getpid()}.ark")
    n_rec = dataset_to_cegs(ds, path, batch_size=2, shuffle_seed=5)
    den = auto_den_graph(corpus.den_graph, device=device)
    model = _model(c, corpus.tree.num_pdfs, corpus.feat_dim, device)
    cegs = CegsDataset(path, append_ivector=False, seed=11)
    trainer = Trainer(model, den, _trainer_config(c, device, batch_size=0, num_epochs=2))
    results = trainer.fit(cegs, log_fn=lambda s: None)
    return dict(records=n_rec, objf=results.objf, steps=results.steps,
                weight=results.tot_weight, curve=_curve(trainer))


def bn_mode(c: dict, device, mesh) -> dict:
    """The batchnorms on this rank's rows of one global input (B=4 rows of
    T=5 frames, C=6 channels, from seed 0), in train mode inside
    `data_parallel`; the loss is sum(y * g) for a fixed global g."""
    from torchain_tpu_torch.models.tdnn import ChainBatchNorm, FlaxBatchNorm, FusedPostBN
    from torchain_tpu_torch.parallel.mesh import (
        all_reduce_tensors_,
        data_parallel,
        global_batch_from_local,
        shard_batch,
    )

    rng = np.random.default_rng(0)
    B, T, C = 4, 5, 6
    glob = dict(x=rng.normal(size=(B, T, C)).astype(np.float32) * 2 + 0.5,
                byp=rng.normal(size=(B, T, C)).astype(np.float32),
                g=rng.normal(size=(B, T, C)).astype(np.float32))
    loc = shard_batch(mesh, glob) if mesh.data > 1 else glob
    cb = torch.tensor(rng.normal(size=(C,)).astype(np.float32), device=device,
                      requires_grad=True)
    out = {}
    for name, make in (("fused", ChainBatchNorm), ("flax", FlaxBatchNorm),
                       ("brb_bypass", FusedPostBN)):
        torch.manual_seed(0)
        bn = make(C, device=device)
        with torch.no_grad():
            bn.scale.copy_(torch.linspace(0.5, 1.5, C))
            bn.bias.copy_(torch.linspace(-0.2, 0.3, C))
        x = torch.tensor(loc["x"], device=device, requires_grad=True)
        with data_parallel(mesh):
            if name == "brb_bypass":
                byp = torch.tensor(loc["byp"], device=device, requires_grad=True)
                y = bn(x, cb, byp, 0.66, train=True)
            else:
                y = bn(x, train=True)
            bn.zero_grad()
            cb.grad = None
            (y * torch.tensor(loc["g"], device=device)).sum().backward()
        grads = [bn.scale.grad, bn.bias.grad] + ([cb.grad] if name == "brb_bypass" else [])
        if mesh.data > 1:
            all_reduce_tensors_(mesh, grads)
        rows = global_batch_from_local(mesh, dict(y=y.detach(), dx=x.grad))
        out[name] = dict(y=rows["y"], dx=rows["dx"], dscale=grads[0], dbias=grads[1],
                         mean=bn.mean, var=bn.var,
                         **({"dcb": grads[2]} if name == "brb_bypass" else {}))
    arrays = {f"{n}_{k}": v.detach().cpu().numpy() for n, d in out.items() for k, v in d.items()}
    if c.get("out") and mesh.rank == 0:
        np.savez(c["out"], **arrays)
    return dict(stats=dict(mesh.stats), fields=sorted(arrays))


def _den(c: dict, corpus, device):
    """config["den"]: "auto" (`auto_den_graph`) or "dense" (the dense Moore
    form through ops/den_dense.py, as tests/test_sharding.py's)."""
    from torchain_tpu_torch.ops import DeviceDenseDenGraph, auto_den_graph

    if c["den"] == "dense":
        return DeviceDenseDenGraph.from_host(corpus.dense_den, device=device)
    return auto_den_graph(corpus.den_graph, device=device)


def _bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if isinstance(t, torch.Tensor))


def model_run(c: dict, device, mesh, corpus, batch) -> dict:
    """One variant of the model mode on this rank's rows of `batch` (the
    global batch)."""
    from torchain_tpu_torch.ops import ChainLossOptions, DeviceSupervision
    from torchain_tpu_torch.parallel.mesh import replicated, shard_batch
    from torchain_tpu_torch.parallel.sharding import (
        gather_leaf_value,
        gathered_state_dict,
        model_axis,
        shard_params,
    )
    from torchain_tpu_torch.train import ChainTrainState, make_train_step
    from torchain_tpu_torch.train.trainer import make_optimizer

    model = _model(c, corpus.tree.num_pdfs, corpus.feat_dim, device)
    replicated(mesh, model)
    shard_params(mesh, model, c["min_shard_size"])
    opt = make_optimizer(_trainer_config(c, device), model.parameters())
    state = ChainTrainState(model=model, optimizer=opt)
    step = make_train_step(state, ChainLossOptions(**c["loss"]), max_grad_norm=0.0, mesh=mesh)
    local = shard_batch(mesh, batch) if mesh.data > 1 else batch
    feats = torch.as_tensor(local.feats).to(device)
    sup = DeviceSupervision.from_host(local.sup, device=device).with_kernel_tables()
    den = _den(c, corpus, device)
    counters = _counters(c)
    for fn in counters.values():
        fn.launches = 0
    before = {axis: dict(v) for axis, v in mesh.stats.items()}
    curve, ticks, first_grads = [], [], None
    for i in range(max(1, c["steps"])):
        m = step(feats, den, sup)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        ticks.append(time.perf_counter())
        curve.append({k: float(m[k]) for k in ("loss", "objf", "grad_norm", "weight")})
        if i == 0:
            # gathered for the record, outside the step's counts
            held = {axis: dict(v) for axis, v in mesh.stats.items()}
            first_grads = {n: gather_leaf_value(p, p.grad).detach().cpu().clone()
                           for n, p in model.named_parameters() if p.grad is not None}
            for axis, v in held.items():
                mesh.stats[axis].update(v)
    steps = len(curve)
    per_step = {axis: {k: (mesh.stats[axis][k] - before[axis][k]) / steps for k in v}
                for axis, v in before.items()}
    params = gathered_state_dict(model)
    if c["save_params"] and mesh.global_rank == 0:
        torch.save(dict(params={k: v.detach().cpu() for k, v in params.items()},
                        first_grads=first_grads), c["save_params"])
    gaps = np.diff(ticks)
    return dict(curve=curve, loss=curve[0]["loss"], objf=curve[0]["objf"],
                grad_norm=curve[0]["grad_norm"],
                step_ms=float(np.median(gaps)) * 1e3 if len(gaps) else None,
                param_bytes=_bytes(model.parameters()), opt_state_bytes=opt.state_bytes(),
                collectives_per_step=per_step,
                launches={k: fn.launches for k, fn in counters.items()},
                sharded={n: model_axis(p) for n, p in model.named_parameters()
                         if model_axis(p) is not None},
                shard_shapes={n: list(p.shape) for n, p in model.named_parameters()
                              if model_axis(p) is not None},
                rows=int(feats.shape[0]))


def model_mode(c: dict, device, mesh) -> dict:
    place = dict(data_rank=mesh.rank, model_rank=mesh.model_rank,
                 global_rank=mesh.global_rank, shape=dict(mesh.shape))
    made: dict = {}

    def one(cv):
        # the corpus and the first unshuffled global batch, once per
        # corpus, data and context
        key = json.dumps([cv[k] for k in ("corpus", "chunk_frames", "sup_opts", "data_seed",
                                          "batch_size", "precompile")]
                         + [_config(cv)[1].context])
        if key not in made:
            corpus, ds = _corpus_and_dataset(cv, _config(cv)[1].context)
            made[key] = corpus, next(ds.batches(cv["batch_size"], shuffle=False))
        return model_run(cv, device, mesh, *made[key])

    if not c["variants"]:
        return dict(mesh=place, **one(c))
    runs = []
    for i, v in enumerate(c["variants"]):
        cv = {**c, **v}
        if cv["save_params"]:
            cv["save_params"] = f"{cv['save_params']}.{i}"
        runs.append(one(cv))
    return dict(mesh=place, variants=runs)


def run(mode: str, rank: int, world: int, device, config: dict | None = None,
        workdir: str = ".") -> dict:
    """One rank (WORLD 1: no process group) in this process; the process
    group, where there is one, must have been joined."""
    from torchain_tpu_torch.parallel import MeshConfig, make_mesh

    c = {**DEFAULTS, **(config or {})}
    device = torch.device(device)
    t0 = time.perf_counter()
    if mode == "trainer":
        out = trainer_mode(c, device, rank)
    elif mode == "cegs":
        out = cegs_mode(c, device, rank, workdir)
    elif mode == "model":
        out = model_mode(c, device, make_mesh(MeshConfig(**c["mesh"]), device_type=device.type))
    else:
        mesh = make_mesh(MeshConfig(data=world, model=1), device_type=device.type)
        out = loss_mode(c, device, mesh) if mode == "loss" else bn_mode(c, device, mesh)
    return dict(rank=rank, world=world, mode=mode, device=str(device),
                seconds=time.perf_counter() - t0, **out)


def spawn(world: int, mode: str, config: dict | None, workdir: str, device: str = "cuda",
          backend: str = "gloo", timeout: float = 240.0, env: dict | None = None) -> list[dict]:
    """Start WORLD ranks of this worker (one process each, a `file://`
    store under `workdir`) and return their results in rank order.  Every
    rank is waited on with `timeout` and killed at its end; a rank that
    fails, or prints no result, raises with the end of its output."""
    os.makedirs(workdir, exist_ok=True)
    store = os.path.join(workdir, f"store_{mode}_{world}_{time.monotonic_ns()}")
    cmd = [sys.executable, "-m", "torchain_tpu_torch.tools.multihost_worker", "", str(world),
           mode, "--init", f"file://{store}", "--device", device, "--backend", backend,
           "--config", json.dumps(config or {}), "--workdir", workdir]
    full_env = {**os.environ, **(env or {})}
    full_env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO), *filter(None, [full_env.get("PYTHONPATH")])])
    procs = []
    try:
        for r in range(world):
            cmd[3] = str(r)
            procs.append(subprocess.Popen(list(cmd), stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True, env=full_env,
                                          cwd=str(REPO)))
        deadline = time.monotonic() + timeout
        outs = []
        for p in procs:
            out, _ = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    results = []
    for r, (p, out) in enumerate(zip(procs, outs)):
        lines = [ln for ln in out.splitlines() if ln.startswith(RESULT)]
        if p.returncode != 0 or not lines:
            raise RuntimeError(f"{mode} rank {r}/{world} exited {p.returncode}:\n{out[-4000:]}")
        results.append(json.loads(lines[-1][len(RESULT):]))
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("rank", type=int)
    ap.add_argument("world", type=int)
    ap.add_argument("mode", choices=("loss", "trainer", "cegs", "bn", "model"))
    ap.add_argument("--init", default=None, help="rendezvous (file://...); default env://")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda, cuda:LOCAL_RANK; cpu runs the plain "
                    "versions of the kernels)")
    ap.add_argument("--backend", default=None)
    ap.add_argument("--config", default="{}", help="JSON: keys of DEFAULTS to override")
    ap.add_argument("--workdir", default=".")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if args.world > 1:
        from torchain_tpu_torch.parallel import init_distributed

        device = init_distributed(device, backend=args.backend, init_method=args.init,
                                  rank=args.rank, world_size=args.world)
    elif device.type == "cuda":
        torch.cuda.set_device(device)
    try:
        out = run(args.mode, args.rank, args.world, device, json.loads(args.config),
                  args.workdir)
        if args.world > 1:
            import torch.distributed as dist

            # no rank tears the group down while another still works in it
            # (rank 0 writes the results' files after the last collective)
            dist.barrier()
    finally:
        if args.world > 1:
            import torch.distributed as dist

            with contextlib.suppress(RuntimeError):
                dist.destroy_process_group()
    print(RESULT + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
