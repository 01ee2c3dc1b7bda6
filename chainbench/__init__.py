"""chainbench: the benchmark of torchain_tpu_torch, LF-MMI acoustic-model
training on one card.  `python3 chainbench/run.py --workload <name> --seed
<n> --seconds <s> --trace <0|1>` runs one cell once (chainbench/run.py)."""
