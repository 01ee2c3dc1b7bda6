"""data/materialize.py of the port against the JAX package's: the same
batches in the same order for several (seed, epoch); placement on a
device (here the CPU) as PlacedBatch, which `Trainer._put_batch` passes
through with no copy and no event; `Trainer.fit` over the placed batches
equal, loss for loss, to `fit` over the same host batches placed step by
step; the refusal of a source that yields no batch; and io.select_device."""

import numpy as np
import pytest

pytest.importorskip("jax")

import torch

from torchain_tpu.data import ChainDataset as JChainDataset
from torchain_tpu.data import MaterializedBatches as JMaterialized
from torchain_tpu.data import synthetic_dataset as j_synth
from torchain_tpu.graphs import SupervisionOptions as JSupOpts
from torchain_tpu_torch.data import (
    ChainDataset,
    MaterializedBatches,
    PlacedBatch,
    synthetic_dataset,
)
from torchain_tpu_torch.graphs import SupervisionOptions

CORPUS = dict(num_utts=12, num_phones=4, feat_dim=8, seed=9)


def _ds(pkg="torch", left=2, right=2):
    synth, cls, opts = ((synthetic_dataset, ChainDataset, SupervisionOptions)
                        if pkg == "torch" else (j_synth, JChainDataset, JSupOpts))
    corpus = synth(**CORPUS)
    return corpus, cls(corpus.utts, corpus.tree, corpus.norm_fst, chunk_frames_out=8,
                       left_context=left, right_context=right,
                       sup_opts=opts(left_tolerance=1, right_tolerance=1))


@pytest.mark.parametrize("seed", [0, 5, 2**31 + 7])
def test_the_jax_packages_batches_in_its_order(seed):
    _, ds = _ds()
    _, jds = _ds("jax")
    mat, jmat = MaterializedBatches(ds, 4, seed=seed), JMaterialized(jds, 4, seed=seed)
    assert len(mat) == len(jmat) > 2
    assert mat.estimate_sup_caps() == tuple(jmat.estimate_sup_caps())
    for epoch in (None, 0, 1, 7):
        got, want = list(mat.batches(4, epoch=epoch)), list(jmat.batches(4, epoch=epoch))
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.feats, b.feats)
            np.testing.assert_array_equal(a.sup.in_src, b.sup.in_src)
    unshuffled = list(mat.batches(4, shuffle=False))
    assert [id(b) for b in unshuffled] == [id(b) for b in mat._batches]
    assert mat.nbytes == jmat.nbytes > 0


def test_device_placement_and_the_trainer_pass_through():
    from torchain_tpu_torch.ops import DeviceSupervision
    from torchain_tpu_torch.train import Trainer, TrainerConfig

    _, ds = _ds()
    host = MaterializedBatches(ds, 4)
    placed = MaterializedBatches(ds, 4, device="cpu")
    assert len(placed) == len(host)
    for h, p in zip(host._batches, placed._batches):
        assert isinstance(p, PlacedBatch) and isinstance(p.sup, DeviceSupervision)
        assert p.feats.device.type == "cpu" and p.sup.arcs_k is not None
        np.testing.assert_array_equal(p.feats.numpy(), h.feats)
    assert placed.nbytes > host.nbytes  # the kernel tables and int64 tables
    trainer = Trainer(torch.nn.Linear(1, 1), None, TrainerConfig(device="cpu"))
    b = placed._batches[0]
    feats, sup, event = trainer._put_batch(b)
    assert feats is b.feats and sup is b.sup and event is None
    assert trainer._ready((feats, sup, event)) == (b.feats, b.sup)


def test_fit_over_placed_batches_equals_fit_over_the_host_batches():
    from torchain_tpu_torch.models import TDNN, TdnnConfig
    from torchain_tpu_torch.ops import auto_den_graph
    from torchain_tpu_torch.train import Trainer, TrainerConfig

    corpus = synthetic_dataset(**CORPUS)
    cfg = TdnnConfig(num_pdfs=corpus.tree.num_pdfs, hidden_dim=32)
    left, right = cfg.context
    _, ds = _ds(left=left, right=right)
    runs = {}
    for name, device in (("ram", False), ("placed", "cpu")):
        model = TDNN(cfg, 8, device="cpu", generator=torch.Generator().manual_seed(3))
        tr = Trainer(model, auto_den_graph(corpus.den_graph, device="cpu"),
                     TrainerConfig(batch_size=4, num_epochs=2, log_every=1, device="cpu",
                                   loader_threads=2))
        tr.fit(MaterializedBatches(ds, 4, device=device), log_fn=lambda *_: None)
        runs[name] = [m["loss"] for m in tr.metrics_log]
    assert len(runs["ram"]) >= 4 and all(np.isfinite(runs["ram"]))
    assert runs["placed"] == runs["ram"]


def test_refusal_of_a_source_without_batches():
    _, ds = _ds()
    with pytest.raises(ValueError, match="no batches"):
        MaterializedBatches(ds, 1000)


def test_a_source_without_caps():
    class Source:
        def batches(self, batch_size, shuffle=True, epoch=None):
            _, ds = _ds()
            return ds.batches(batch_size, shuffle=shuffle, epoch=epoch)

    mat = MaterializedBatches(Source(), 4)
    assert len(mat) > 0
    with pytest.raises(ValueError, match="estimate_sup_caps"):
        mat.estimate_sup_caps()


def test_select_device_checks_a_torch_device():
    from torchain_tpu_torch.io import select_device

    assert select_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert select_device() == select_device("gpu") == torch.device("cuda:0")
    else:
        assert select_device() == torch.device("cpu")
        for name in ("cuda", "gpu"):
            with pytest.raises(RuntimeError, match="absent"):
                select_device(name)
    with pytest.raises(RuntimeError, match="absent"):
        select_device("tpu")
