"""graphs — host-side compilers from linguistic structure to packed arrays.

HMM topology + context tree (kaldi/src/hmm/), the phone-LM estimator
(kaldi/src/chain/language-model.cc), the denominator-graph compiler
(kaldi/src/chain/chain-den-graph.cc), the supervision compiler
(kaldi/src/chain/chain-supervision.cc), and the flat-start (e2e) supervision
of kaldi/src/chain/chain-generic-numerator.cc, and the word-level decoding
graph (HCLG, hclg.py).  Everything here runs on the host
CPU at setup/data-loading time and emits packed numpy arrays for the
device code in `torchain_tpu_torch.ops`.
"""

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
from torchain_tpu_torch.graphs.topology import BOUNDARY, ChainTopology, ContextTree

__all__ = [
    "BOUNDARY",
    "ChainTopology",
    "ContextTree",
    "DenGraph",
    "DenseDenGraph",
    "E2eSupervision",
    "Lexicon",
    "PhoneLmOptions",
    "Supervision",
    "SupervisionOptions",
    "alignment_to_supervision_fst",
    "compile_den_graph",
    "compile_e2e_supervision",
    "compile_supervision",
    "estimate_phone_lm",
    "make_den_fst",
    "make_dense_den_graph",
    "make_e2e_supervision_fst",
    "make_hclg",
    "make_normalization_fst",
    "numerator_tables",
    "pad_and_stack_e2e",
    "pad_and_stack_supervisions",
    "split_alignment_into_chunks",
    "subsample_alignment",
    "transcript_to_e2e_fst",
]
