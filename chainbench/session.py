"""One run of a cell: set-up (corpus, the program's graphs, egs and model,
the trainer and its captured steps), the first steps whose readings the
comparison takes, the measured window, a traced window, and the reference.

Set-up phases are timed on the host clock and kept in `phases`.  The
first steps go through the window's own call and feed (`Trainer.fit` on
`Feed`): step 1 is read from the optimizer's state after it, steps 1..n's
losses from their metrics, the parameters' change after step n before step
n + 1 runs, and the constrained parameters just before and after the
first semi-orthogonal constraint (at step 4, inside the first steps where
they reach it).  The warm-up runs on to `warmup_steps`, so that every graph
the window replays is captured before it opens (the constraint's at step
4).  How batches reach the card is the mix's `placement`
(`chainbench/placements/<name>.py`), and whether steps are captured its
`capture`.
"""

from __future__ import annotations

import gc
import importlib
import statistics
import time

import numpy as np
import torch

from chainbench import check, devtrace, program, spec
from chainbench.corpus import make_corpus
from chainbench.reference import train as reference_train
from chainbench.reference.chain import DenGraph, initial_probs
from chainbench.reference.lattice import chunk_lattice, live_sizes, product
from chainbench.rooflines import model_flops
from chainbench.weights import make_weights


def _noop(*_a, **_k):
    return None


class Session:
    def __init__(self, cell, seed: int, device: str = "cuda", workers: int | None = None):
        self.cell, self.seed, self.device = cell, int(seed), device
        self.workers = workers
        cfg, tr = cell.config, cell.traffic
        self.B, self.T = tr["batch_size"], tr["chunk_frames_out"]
        self.ref_module = cfg["reference"]["module"]
        self.ref_trunk = importlib.import_module(f"chainbench.reference.{self.ref_module}")
        self.context = self.ref_trunk.context(cfg["reference"])
        self.phases: dict = {}
        self.program_readings = None

    def _phase(self, name: str, t0: float) -> float:
        t1 = time.perf_counter()
        self.phases[name] = t1 - t0
        return t1

    def _sync(self):
        if self.device == "cuda":
            torch.cuda.synchronize()

    # -- set-up --------------------------------------------------------------

    def setup(self) -> None:
        cfg, tr = self.cell.config, self.cell.traffic
        B, n_batches = self.B, tr["distinct_batches"]
        t = time.perf_counter()
        if self.device == "cuda":
            from torchain_tpu_torch import kernels

            kernels.build()
            t = self._phase("kernels_s", t)
        self.corpus = make_corpus(self.seed, cfg["corpus"], self.T, B * n_batches)
        t = self._phase("corpus_s", t)
        graph, norm, tree = program.host_graphs(self.corpus)
        self.den_device = program.auto_den_graph(graph, device=self.device)
        t = self._phase("graphs_s", t)
        ds = program.chain_dataset(self.corpus, norm, tree, tr, self.context)
        ds.precompile(self.workers)
        if ds.num_dropped:
            raise RuntimeError(f"{ds.num_dropped} chunks' supervision failed to compile")
        t = self._phase("egs_s", t)
        placement = spec.module("placements", tr["placement"], self.cell.here)
        self.feed = placement.feed(ds, B, self.device)
        if len(self.feed.placed) != n_batches:
            raise RuntimeError(f"{len(self.feed.placed)} batches, not {n_batches}")
        self._sync()
        t = self._phase("place_s", t)
        num_pdfs = self.corpus.tree.num_pdfs
        self.model = program.make_model(cfg, num_pdfs, self.corpus.feat_dim, self.device)
        shapes = {n: tuple(p.shape) for n, p in self.model.named_parameters()}
        self.params0 = make_weights(shapes, self.seed, self.device)
        program.load_parameters(self.model, self.params0)
        self._sync()
        t = self._phase("model_s", t)
        self.trainer = program.make_trainer(self.model, self.den_device, cfg, tr, self.device)
        self.probe = program.StepProbe(self.trainer, self.feed, tr["checked_steps"])
        self._first_steps()
        self._sync()
        self._phase("capture_s", t)

    def _fit_to(self, step: int) -> None:
        self.trainer.fit(self.feed, log_fn=_noop, max_steps=step)

    def _watch_constraint(self) -> None:
        """Keep the constrained parameters (on the host) just before and
        just after the Trainer's first semi-orthogonal constraint, then
        leave the Trainer's own call in place."""
        params = dict(self.model.named_parameters())
        names = getattr(self.ref_trunk, "constrained", lambda _names: [])(list(params))
        if not names:
            return
        trainer = self.trainer
        constraint = trainer._semi_orthogonal

        def first():
            before = {n: params[n].detach().cpu().clone() for n in names}
            constraint()
            self._sync()
            self.ortho = dict(ortho_in=before,
                              ortho_out={n: params[n].detach().cpu().clone() for n in names})
            del trainer._semi_orthogonal

        trainer._semi_orthogonal = first

    def _first_steps(self) -> None:
        tr = self.cell.traffic
        n = tr["checked_steps"]
        names = [name for name, p in self.model.named_parameters() if p.requires_grad]
        self.ortho = {}
        self._watch_constraint()
        self._fit_to(1)
        state = self.trainer.state.optimizer.state_dict()["inner"]["state"]
        b1 = self.trainer.state.optimizer.inner.param_groups[0]["betas"][0]
        # on the host: nothing the window's peak memory would count
        grad1_vec = {name: (state[i]["exp_avg"].detach() / (1 - b1)).cpu()
                     for i, name in enumerate(names)}
        self._fit_to(n)
        with torch.no_grad():
            change_vec = {name: (p - self.params0[name]).cpu()
                          for name, p in self.model.named_parameters()}
        loss = [float(m["loss"]) for m in self.probe.metrics]
        self.program_readings = dict(loss=loss, grad1_vec=grad1_vec, change_vec=change_vec,
                                     batches=list(self.probe.used[:n]), **self.ortho)
        self._fit_to(max(n, tr["warmup_steps"]))

    # -- the windows ---------------------------------------------------------

    def window(self, seconds: float) -> dict:
        """Train for `seconds` on the host clock from a synchronize; every
        step's start recorded on the card."""
        tr = self.trainer
        step0, host0 = int(tr.state.step), len(tr.timings["step_s"])
        failed0 = tr.results.tot_failed
        self.probe.events = [] if self.device == "cuda" else None
        self._sync()
        t0 = time.perf_counter()
        self.feed.deadline = t0 + seconds
        tr.fit(self.feed, log_fn=_noop)
        self._sync()
        t1 = time.perf_counter()
        self.feed.deadline = None
        events, self.probe.events = self.probe.events, None
        steps = int(tr.state.step) - step0
        intervals = [a.elapsed_time(b) for a, b in zip(events, events[1:])] if events else []
        host = np.diff(tr.timings["step_s"][host0:]) * 1e3
        return dict(steps=steps, first_step=step0 + 1, window_s=t1 - t0, intervals_ms=intervals,
                    host_ms=float(statistics.median(host)) if len(host) else None,
                    failed=tr.results.tot_failed - failed0)

    def traced(self, steps: int) -> devtrace.Trace:
        target = int(self.trainer.state.step) + steps
        return devtrace.profile(lambda: self._fit_to(target), steps)

    def release(self) -> None:
        """Free the program's state (the card's memory is the reference's
        next)."""
        for name in ("trainer", "probe", "feed", "model", "den_device"):
            setattr(self, name, None)
        gc.collect()
        if self.device == "cuda":
            torch.cuda.empty_cache()

    # -- the reference -------------------------------------------------------

    def batch_rows(self, k: int) -> tuple:
        """(feats [B, T_in, F] on the device, lattices) of batch k: chunks
        kB..(k+1)B-1 of the corpus."""
        tr, c = self.cell.traffic, self.corpus
        chunks = c.chunks[k * self.B:(k + 1) * self.B]
        feats = np.stack([c.chunk_feats(ch, self.T, *self.context) for ch in chunks])
        lattices = [chunk_lattice(ch.ali, c.tree.pdf, ch.left, *tr["tolerance"])
                    for ch in chunks]
        return torch.as_tensor(feats, device=self.device), lattices

    def reference_graph(self) -> DenGraph:
        d = self.corpus.den
        init = initial_probs(d.num_states, d.src, d.dst, d.logw)
        return DenGraph(d.num_states, d.src, d.dst, d.label, d.logw, init, self.device)

    def reference(self, precision: str = "float32", fault: str | None = None) -> dict:
        """The reference's readings over the batches the program's first
        steps took, from the same parameters; TF32 off."""
        cfg = self.cell.config
        batches = [self.batch_rows(k) for k in self.program_readings["batches"]]
        tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        try:
            return reference_train.run_steps(
                self.params0, batches, self.reference_graph(), self.ref_module,
                cfg["reference"], cfg["loss"], self.cell.traffic["trainer"],
                precision, fault)
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32

    def compare(self, ref: dict) -> tuple:
        return check.verdict(check.numbers(self.program_readings, ref), self.cell.limits)

    # -- sizes the rooflines count --------------------------------------------

    def sizes(self) -> dict:
        """Shapes and counts of this cell's inputs (the benchmark's own
        arrays): the denominator's states, distinct arcs and (destination,
        pdf) pairs, and the numerator's live sizes averaged over the
        batches."""
        d, c = self.corpus.den, self.cell.config
        arcs = np.unique(np.stack([d.src, d.dst, d.label]), axis=1)
        live_pairs = len(np.unique(arcs[1] * (1 << 20) + arcs[2]))
        num = []
        for k in range(self.cell.traffic["distinct_batches"]):
            _, lattices = self.batch_rows(k)
            num.append(live_sizes(product(lattices, d.src, d.dst, d.label), d.num_states))
        T_in = self.T * self.corpus.fsf + sum(self.context)
        return dict(
            B=self.B, T=self.T, T_in=T_in, P=self.corpus.tree.num_pdfs,
            S=d.num_states, nnz=int(arcs.shape[1]), live=live_pairs,
            num={k: float(np.mean([n[k] for n in num])) for k in num[0]},
            flops=model_flops(self.ref_module, c["reference"], self.B, T_in,
                              self.corpus.feat_dim, self.corpus.tree.num_pdfs),
        )
