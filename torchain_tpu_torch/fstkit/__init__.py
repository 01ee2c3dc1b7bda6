"""fstkit — a minimal weighted acceptor-FST library (host side).

Conventions:
  * Weights are LOG-PROBABILITIES (higher is more likely).  Path weight is
    the sum of arc log-weights plus the final log-weight.
  * Label 0 is epsilon.  Real symbols (phones, pdf-ids+1) start at 1.
  * The start state is always state 0.
"""

from torchain_tpu_torch.fstkit.algorithms import (
    arcsort,
    bfs_time_sort,
    compose,
    connect,
)
from torchain_tpu_torch.fstkit.fst import NEG_INF, Arc, Fst

__all__ = [
    "Arc",
    "Fst",
    "NEG_INF",
    "arcsort",
    "bfs_time_sort",
    "compose",
    "connect",
]
