"""Run one cell of the benchmark of ``seal_tpu_torch`` on this machine's card.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Prints the checked numbers on its last lines
of standard error and one JSON object as its last line of standard output;
exits 2 without a result where the cell's cards are missing, 3 where the
run loaded JAX or the JAX package.
"""

import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T0))
