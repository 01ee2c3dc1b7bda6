"""`python -m chainbench --workload <name> --seed <n> --seconds <s> --trace <0|1>`:
the same as `python3 chainbench/run.py`."""

import sys

from chainbench.run import main

sys.exit(main())
