"""fstkit — a minimal weighted acceptor-FST library (host side).

Scope-limited replacement for the slice of OpenFst that Kaldi's chain code
uses: acceptors over integer labels with compose / connect /
epsilon-removal / topological and breadth-first time sorting /
shortest-distance, path enumeration used by the test oracles, and the
binary OpenFst file format (openfst_io).

Conventions:
  * Weights are LOG-PROBABILITIES (higher is more likely).  Path weight is
    the sum of arc log-weights plus the final log-weight; the weight of a set
    of paths is the logsumexp (log semiring) or max (tropical/Viterbi).
  * Label 0 is epsilon.  Real symbols (phones, pdf-ids+1) start at 1.
  * The start state is always state 0.
"""

from torchain_tpu_torch.fstkit.algorithms import (
    arcsort,
    bfs_time_sort,
    compose,
    connect,
    enumerate_paths,
    merge_bisimilar,
    reverse,
    rm_epsilon,
    shortest_distance,
    topsort,
    total_weight,
)
from torchain_tpu_torch.fstkit.fst import NEG_INF, Arc, Fst
from torchain_tpu_torch.fstkit.openfst_io import (
    RawArc,
    RawFst,
    read_openfst,
    read_openfst_raw,
    write_openfst,
    write_openfst_raw,
)

__all__ = [
    "Arc",
    "Fst",
    "NEG_INF",
    "RawArc",
    "RawFst",
    "read_openfst",
    "read_openfst_raw",
    "write_openfst",
    "write_openfst_raw",
    "arcsort",
    "bfs_time_sort",
    "compose",
    "connect",
    "enumerate_paths",
    "merge_bisimilar",
    "reverse",
    "rm_epsilon",
    "shortest_distance",
    "topsort",
    "total_weight",
]
