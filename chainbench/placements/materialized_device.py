"""Egs compiled once at set-up and placed on the card once
(`MaterializedBatches(..., device=True)`), then replayed epoch after epoch,
as `cli.train --materialize-egs device` trains: no host-to-device traffic
inside the window."""

from __future__ import annotations

from chainbench import program


def feed(dataset, batch_size: int, device) -> program.Feed:
    """The window's feed over `dataset`'s batches in the corpus's order."""
    return program.Feed(program.MaterializedBatches(program.InOrder(dataset), batch_size,
                                                    device=device), batch_size)
