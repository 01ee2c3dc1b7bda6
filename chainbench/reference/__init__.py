"""The plain reference of the benchmark's cells: the trunks (`tdnnf`,
`conformer`), the chain loss (`chain`, `lattice`), the optimizer chain
(`optim`, with its update rules in `optimizers`) and their first training steps (`train`), in plain PyTorch and
NumPy, float32 (TF32 off: the caller sets it).  It imports nothing of the
program and takes nothing the program made: the corpus
(chainbench/corpus), the initial parameters and the batches' rows come from
the benchmark.  One stage is followed from the program's own state: the
first semi-orthogonal constraint is applied to the program's parameters as
they were just before it (chainbench/check.py, `ortho_step`)."""
