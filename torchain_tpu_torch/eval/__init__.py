"""eval — Viterbi decoding, lattices, forced alignment, error-rate scoring
(port of torchain_tpu/eval).

Replaces the reference recipe's decode stage (SURVEY.md section 3.4:
posterior ark export -> latgen-faster-mapped -> scoring) with an in-repo
path: the model's forward (train/step.py make_forward_fn) for chain-head
pseudo-loglikes, a token-passing Viterbi decoder and lattice generator
over the phone- or word-level decoding graph (acoustic scale 1.0, chain
convention; host NumPy and the C++ core in csrc/decoder.cc), and WER/PER
scoring.  Decoding runs on the host, one utterance at a time.
"""

from torchain_tpu_torch.eval.align import align_corpus, force_align
from torchain_tpu_torch.eval.decoder import (
    DecodingGraph,
    hclg_decoding_graph,
    make_decoding_graph,
    make_word_decoding_graph,
    pack_decoding_graph,
    viterbi_decode,
)
from torchain_tpu_torch.eval.lattice import (
    MbrResult,
    CtmEntry,
    best_path_ctm,
    determinize_lattice,
    lattice_arc_posteriors,
    lattice_best_path,
    lattice_decode,
    lattice_nbest,
    lattice_oracle,
    lattice_to_text,
    lmrescore_lattice,
    prune_lattice,
    mbr_decode,
    read_lattice_ark,
    read_lattice_ark_binary,
    read_ctm,
    rescore_lattice,
    score_sweep,
    write_ctm,
    write_lattice_ark,
    write_lattice_ark_binary,
)
from torchain_tpu_torch.eval.wer import edit_distance, wer

__all__ = [
    "DecodingGraph",
    "align_corpus",
    "force_align",
    "hclg_decoding_graph",
    "make_decoding_graph",
    "make_word_decoding_graph",
    "pack_decoding_graph",
    "viterbi_decode",
    "MbrResult",
    "determinize_lattice",
    "lattice_arc_posteriors",
    "CtmEntry",
    "best_path_ctm",
    "write_ctm",
    "read_ctm",
    "lattice_best_path",
    "lattice_decode",
    "lattice_nbest",
    "lattice_oracle",
    "prune_lattice",
    "lattice_to_text",
    "lmrescore_lattice",
    "mbr_decode",
    "read_lattice_ark",
    "read_lattice_ark_binary",
    "rescore_lattice",
    "score_sweep",
    "write_lattice_ark",
    "write_lattice_ark_binary",
    "edit_distance",
    "wer",
]
