"""utils — Kaldi binary stream primitives (kaldi_io)."""
