"""graphs — host-side compilers from linguistic structure to packed arrays.

HMM topology + context tree (kaldi/src/hmm/), the phone-LM estimator
(kaldi/src/chain/language-model.cc), the denominator-graph compiler
(kaldi/src/chain/chain-den-graph.cc), the supervision compiler
(kaldi/src/chain/chain-supervision.cc), and the flat-start (e2e) supervision
of kaldi/src/chain/chain-generic-numerator.cc, the word-level decoding
graph (HCLG, hclg.py), lattice supervision, the de Bruijn lift of the
denominator graph (debruijn.py), and the Kaldi model files: the
transition model and its alignments, tied context trees, and the nnet3
body of a `final.mdl`.  Everything here runs on the host
CPU at setup/data-loading time and emits packed numpy arrays for the
device code in `torchain_tpu_torch.ops`.
"""

from torchain_tpu_torch.graphs.debruijn import (
    DeBruijnDenGraph,
    make_debruijn_den_graph,
    materialize_lift_fst,
)
from torchain_tpu_torch.graphs.den_graph import (
    DenGraph,
    DenseDenGraph,
    compile_den_graph,
    make_den_fst,
    make_dense_den_graph,
    make_normalization_fst,
)
from torchain_tpu_torch.graphs.e2e import (
    E2eSupervision,
    compile_e2e_supervision,
    make_e2e_supervision_fst,
    pad_and_stack_e2e,
    transcript_to_e2e_fst,
)
from torchain_tpu_torch.graphs.hclg import Lexicon, make_hclg
from torchain_tpu_torch.graphs.lattice_supervision import (
    PhoneLattice,
    lattice_to_supervision_fst,
)
from torchain_tpu_torch.graphs.nnet3 import AmNnet, Nnet, read_am_nnet, write_am_nnet
from torchain_tpu_torch.graphs.phone_lm import PhoneLmOptions, estimate_phone_lm
from torchain_tpu_torch.graphs.supervision import (
    Supervision,
    SupervisionOptions,
    alignment_to_supervision_fst,
    compile_supervision,
    numerator_tables,
    pad_and_stack_supervisions,
    split_alignment_into_chunks,
    subsample_alignment,
)
from torchain_tpu_torch.graphs.tied_tree import (
    TiedTree,
    TreeStats,
    accumulate_tree_stats,
    build_tied_tree,
    read_kaldi_tree,
    write_kaldi_tree,
)
from torchain_tpu_torch.graphs.topology import BOUNDARY, ChainTopology, ContextTree
from torchain_tpu_torch.graphs.transition_model import (
    HmmTopology,
    TransitionModel,
    chain_transition_model,
    read_ali_ark,
    read_transition_model,
    write_ali_ark,
    write_transition_model,
)

__all__ = [
    "AmNnet",
    "BOUNDARY",
    "ChainTopology",
    "ContextTree",
    "DeBruijnDenGraph",
    "DenGraph",
    "DenseDenGraph",
    "E2eSupervision",
    "HmmTopology",
    "Lexicon",
    "Nnet",
    "PhoneLattice",
    "PhoneLmOptions",
    "Supervision",
    "SupervisionOptions",
    "TiedTree",
    "TransitionModel",
    "TreeStats",
    "accumulate_tree_stats",
    "alignment_to_supervision_fst",
    "build_tied_tree",
    "chain_transition_model",
    "compile_den_graph",
    "compile_e2e_supervision",
    "compile_supervision",
    "estimate_phone_lm",
    "lattice_to_supervision_fst",
    "make_debruijn_den_graph",
    "make_den_fst",
    "make_dense_den_graph",
    "make_e2e_supervision_fst",
    "make_hclg",
    "make_normalization_fst",
    "materialize_lift_fst",
    "numerator_tables",
    "pad_and_stack_e2e",
    "pad_and_stack_supervisions",
    "read_ali_ark",
    "read_am_nnet",
    "read_kaldi_tree",
    "read_transition_model",
    "split_alignment_into_chunks",
    "subsample_alignment",
    "transcript_to_e2e_fst",
    "write_ali_ark",
    "write_am_nnet",
    "write_kaldi_tree",
    "write_transition_model",
]
