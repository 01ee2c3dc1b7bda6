"""Merged minibatches materialized once and replayed per epoch, in host
memory or on the device; port of torchain_tpu/data/materialize.py.

Kaldi's production workflow materializes egs ONCE offline
(nnet3-chain-get-egs | shuffle | merge) and every epoch re-reads the same
merged archives — after merging, the minibatch GROUPING is fixed; only the
visit order varies.  The in-process ChainDataset instead re-pads/stacks
every epoch, and CegsDataset re-reads and re-splits every record.
`MaterializedBatches` restores the Kaldi economics in process: one
materialization pass through the source dataset, then per-epoch replay
with only the order reshuffled (the JAX package's order for the same
(seed, epoch)) — per-batch cost collapses to device placement, or to
nothing where the batches were placed on the device once.

Memory: host batches are held as their NumPy arrays (tens of MB per
production batch), device batches as tensors on the device, so this suits
corpora that fit.  For corpora beyond that, train from the disk:
`dataset_to_cegs` once, then `cli.train --cegs`.

Frame-shift augmentation note: materialization pins the source dataset's
current `frame_shift`; the per-epoch `frame_shift_cycle` trainer option
needs the live loader (Kaldi equivalent: nnet3-chain-copy-egs
--frame-shift re-reads the archive per epoch).
"""

from __future__ import annotations

import dataclasses

import numpy as np


def live_arcs(batches) -> "int | None":
    """The most live steady arcs (frames >= 1) of any sequence of the host
    `batches` (ChainBatch): the `L_cap` that places all of them at one
    live-arc list width; None where a batch is flat-start (its
    supervision has no such list)."""
    from torchain_tpu_torch.graphs.e2e import E2eSupervision

    need = 1
    for b in batches:
        if isinstance(b.sup, E2eSupervision):
            return None
        src = b.sup.in_src if b.sup.in_src.ndim == 4 else b.sup.in_src[None]
        need = max(need, int((src[:, 1:] >= 0).reshape(src.shape[0], -1).sum(1).max()))
    return need


@dataclasses.dataclass
class PlacedBatch:
    """A minibatch already resident on a device: `feats` a tensor, `sup` a
    DeviceSupervision with its kernel tables.  Exposes the attribute
    surface the trainer reads (`feats.shape`, `sup.num_frames`), and
    `Trainer._put_batch` passes it through: no copy, and no event for the
    step to wait on."""

    feats: "torch.Tensor"  # noqa: F821 — torch is imported where batches are placed
    sup: object


class MaterializedBatches:
    """Duck-types the dataset surface Trainer.fit consumes (`batches`,
    `estimate_sup_caps`, `estimate_live_arcs`) over a fixed list of
    pre-built ChainBatch (or PlacedBatch) objects."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        sup_caps: "tuple[int, ...] | None" = None,
        seed: int = 0,
        process_index: "int | None" = None,
        process_count: "int | None" = None,
        device=False,
    ):
        """`device` False keeps host batches.  True (the card) or a torch
        device (or its name) places every batch there ONCE at
        materialization — feats as a tensor, the supervision as
        `DeviceSupervision.from_host(sup).with_kernel_tables(L_cap=
        estimate_live_arcs())` — and epochs
        replay the resident tensors with no per-step host->device traffic.
        Supervision tensors are constant across epochs by construction
        (Kaldi's merged archives are too), so nothing is lost.  `seed` and
        the epoch give the replay order, the JAX package's for the same
        pair.

        With `process_index`/`process_count` (data parallelism) each batch
        holds this rank's rows of a global batch of `batch_size` (the
        source's `batches` cuts them); every rank then replays the same
        order.  `device` with more than one process raises, as in the JAX
        package: several ranks stream their shards."""
        self.seed = seed
        self.process_count = process_count or 1
        self._caps = (
            sup_caps
            if sup_caps is not None
            else dataset.estimate_sup_caps()
            if hasattr(dataset, "estimate_sup_caps")
            else None
        )
        kw = {}
        if self._caps is not None:
            kw["sup_caps"] = self._caps
        if self.process_count > 1:
            if device:
                raise ValueError(
                    "device=True materialization is single-process; "
                    "multi-host runs stream their shards"
                )
            kw["process_index"] = process_index
            kw["process_count"] = process_count
        self._batches = list(dataset.batches(batch_size, shuffle=True, epoch=0, **kw))
        if not self._batches:
            raise ValueError("source dataset yielded no batches")
        self._live = live_arcs(self._batches)
        if device:
            import torch

            from torchain_tpu_torch.ops.device_graphs import DeviceSupervision

            dev = torch.device("cuda" if device is True else device)
            self._batches = [
                PlacedBatch(
                    feats=torch.as_tensor(b.feats, device=dev),
                    # kernel-layout numerator tables prepared once at
                    # placement: every epoch's replay pays nothing for them
                    # at one live-arc list width, as a captured step needs
                    sup=DeviceSupervision.from_host(b.sup, device=dev).with_kernel_tables(
                        L_cap=self._live),
                )
                for b in self._batches
            ]
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    def __len__(self) -> int:
        return len(self._batches)

    @property
    def nbytes(self) -> int:
        """Bytes the materialized batches hold (host or device)."""
        total = 0
        for b in self._batches:
            for obj in (b.feats, b.sup):
                if hasattr(obj, "nbytes"):
                    total += obj.nbytes
                else:
                    for f in dataclasses.fields(obj):
                        v = getattr(obj, f.name)
                        if hasattr(v, "nbytes"):
                            total += v.nbytes
        return total

    def estimate_sup_caps(self):
        if self._caps is None:
            raise ValueError("source dataset had no estimate_sup_caps")
        return self._caps

    def estimate_live_arcs(self) -> int:
        """The live-arc list width that places every batch at one shape
        (`live_arcs`; device batches were placed at it).  Flat-start
        batches have none: ValueError."""
        if self._live is None:
            raise ValueError("flat-start batches: no live-arc width fixes their shape")
        return self._live

    def batches(
        self,
        batch_size: int,  # ignored: fixed at materialization
        shuffle: bool = True,
        drop_last: bool = True,
        epoch: "int | None" = None,
        process_index: "int | None" = None,
        process_count: "int | None" = None,
        sup_caps: "tuple[int, ...] | None" = None,
        num_threads: "int | None" = None,
    ):
        del batch_size, drop_last, sup_caps, num_threads
        if process_count is not None and process_count > 1:
            raise ValueError(
                "multi-host sharding must be applied at materialization "
                "time (pass process_index/process_count to the "
                "constructor)"
            )
        order = np.arange(len(self._batches))
        if shuffle:
            rng = np.random.default_rng([self.seed & 0x7FFFFFFF, int(epoch or 0)])
            rng.shuffle(order)
        for i in order:
            yield self._batches[int(i)]
