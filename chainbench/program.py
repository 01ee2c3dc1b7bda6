"""The system under test, built from the benchmark's inputs through the
program's own entry points: the denominator FST becomes the program's
graph (`compile_den_graph`, `auto_den_graph`), the utterances its
`ChainDataset` with the egs compiled once in forked workers
(`precompile`) and made into batches once (`MaterializedBatches`), the
model its TDNN-F or conformer, and training its `Trainer`.

The benchmark fixes what the batches hold: batch k is chunks kB..(k+1)B-1
in the corpus's order (`InOrder`), and the window takes them in turn
(`Feed`), so that no step replays the batch before it and the reference
knows each step's rows.  How the batches reach the card is the mix's
`placement` (`chainbench/placements/<name>.py`), and whether steps are
captured its `capture`.  `StepProbe` sits between `Trainer.fit` and the
captured step: it records a CUDA event before each step, notes which batch
the step took, and keeps the first steps' metrics.
"""

from __future__ import annotations

import collections
import time

import numpy as np
import torch

from torchain_tpu_torch.data import ChainDataset, MaterializedBatches, Utterance
from torchain_tpu_torch.fstkit import Fst
from torchain_tpu_torch.graphs import (
    ContextTree,
    SupervisionOptions,
    compile_den_graph,
    make_normalization_fst,
)
from torchain_tpu_torch.ops import ChainLossOptions, auto_den_graph
from torchain_tpu_torch import models
from torchain_tpu_torch.train.trainer import Trainer, TrainerConfig


def den_fst(corpus) -> Fst:
    """The corpus's denominator arcs as the program's FST (labels pdf + 1)."""
    den = corpus.den
    fst = Fst()
    fst.add_states(den.num_states)
    for s, d, pdf, w in zip(den.src.tolist(), den.dst.tolist(), den.label.tolist(),
                            den.logw.tolist()):
        fst.add_arc(s, pdf + 1, w, d)
    for s in np.flatnonzero(np.isfinite(den.final)).tolist():
        fst.set_final(s, float(den.final[s]))
    return fst


def host_graphs(corpus):
    """(the program's host den graph, its normalization FST, its tree)."""
    fst = den_fst(corpus)
    graph = compile_den_graph(fst, corpus.tree.num_pdfs)
    return graph, make_normalization_fst(fst, graph.initial_probs), ContextTree(
        corpus.tree.num_phones, context_width=2)


def chain_dataset(corpus, norm, tree, traffic: dict, context: tuple) -> ChainDataset:
    utts = [Utterance(feats=f, alignment=a, utt_id=f"utt{i}")
            for i, (f, a) in enumerate(zip(corpus.feats, corpus.alignments))]
    tol_left, tol_right = traffic["tolerance"]
    return ChainDataset(
        utts, tree, norm, chunk_frames_out=traffic["chunk_frames_out"],
        left_context=context[0], right_context=context[1],
        sup_opts=SupervisionOptions(left_tolerance=tol_left, right_tolerance=tol_right,
                                    frame_subsampling_factor=corpus.fsf))


class InOrder:
    """A ChainDataset whose batches keep the corpus's chunk order."""

    def __init__(self, dataset: ChainDataset):
        self.dataset = dataset

    def estimate_sup_caps(self):
        return self.dataset.estimate_sup_caps()

    def batches(self, batch_size, **kw):
        kw["shuffle"] = False
        return self.dataset.batches(batch_size, **kw)


class Feed:
    """The source's batches in turn from the one after the last a step
    took, until the host clock passes `deadline` (None: without end); the
    dataset surface `Trainer.fit` reads.  `source` is a dataset whose
    batches are made once (a placement's `MaterializedBatches`); each
    `batches` call notes the number of every batch it yields, in order, so
    that the step that takes it can name it (`take`) however the Trainer
    moves it on the way."""

    def __init__(self, source, batch_size: int):
        self.source = source
        self.placed = list(source.batches(batch_size, shuffle=False))
        self.next = 0
        self.deadline = None
        self.queue: collections.deque = collections.deque()

    def estimate_sup_caps(self):
        return self.source.estimate_sup_caps()

    def estimate_live_arcs(self):
        return self.source.estimate_live_arcs()

    def take(self) -> int:
        """The number of the batch the step about to run took."""
        k = self.queue.popleft()
        self.next = k + 1
        return k

    def batches(self, batch_size, **kw):
        queue = self.queue = collections.deque()
        i = self.next
        while self.deadline is None or time.perf_counter() < self.deadline:
            k = i % len(self.placed)
            queue.append(k)
            yield self.placed[k]
            i += 1


class StepProbe:
    """Stands in for `trainer.train_step`: records a timing event before
    each step where `events` is a list, the batch each step took, and the
    metrics of the first `keep` steps."""

    def __init__(self, trainer: Trainer, feed: Feed, keep: int):
        self.step, self.feed, self.keep = trainer.train_step, feed, keep
        self.events = None
        self.used: list = []
        self.metrics: list = []
        trainer.train_step = self

    def __call__(self, feats, den, sup, *rest):
        if self.events is not None:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.events.append(ev)
        self.used.append(self.feed.take())
        metrics = self.step(feats, den, sup, *rest)
        if len(self.metrics) < self.keep:
            self.metrics.append(metrics)
        return metrics


def model_config(config: dict, num_pdfs: int):
    m = config["model"]
    kw = dict(m["kwargs"])
    kw["dtype"] = getattr(torch, kw["dtype"])
    return getattr(models, m["config_class"])(num_pdfs=num_pdfs, **kw)


def make_model(config: dict, num_pdfs: int, feat_dim: int, device="cuda"):
    """The program's model on `device` (its own initial parameters, which
    the benchmark then replaces: `load_parameters`)."""
    return getattr(models, config["model"]["class"])(model_config(config, num_pdfs),
                                                     feat_dim, device=device)


def load_parameters(model, params: dict) -> None:
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(params[name])


def make_trainer(model, den_device, config: dict, traffic: dict, device="cuda") -> Trainer:
    """The Trainer of the mix's recipe (`traffic["trainer"]`), every step
    captured where the mix's `capture` says so."""
    cfg = TrainerConfig(batch_size=traffic["batch_size"], num_epochs=1,
                        capture=bool(traffic["capture"]), device=device,
                        loss=ChainLossOptions(**config["loss"]), **traffic["trainer"])
    return Trainer(model, den_device, cfg)
