"""cli — command-line tools over the Kaldi interchange formats."""
