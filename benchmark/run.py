"""Runs one cell of the benchmark once and prints its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the CUDA cards the cell asks
for; without them it exits 2 and prints no result.  The last line of
standard output is the result (JSON); the last lines of standard error are
the numbers the reference check compared, each beside its limit.
"""

import os
import sys
import time

T_START = time.perf_counter()

if __name__ == "__main__":
    # the checkout's root, so that `benchmark` and the program import
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from benchmark.harness import main

    sys.exit(main(sys.argv[1:], T_START))
