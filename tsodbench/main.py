"""Run one cell of BENCHMARK.json once, from the root of a checkout:

    python3 tsodbench/main.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Set-up (build, weights, inputs, warm-up), a measured window of ``--seconds``,
the output check against the plain reference, and one JSON line last on
standard output.  Exits non-zero, printing no result, where there is no
CUDA card or the program cannot be imported.
"""

import os
import sys

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from tsodbench import harness

    sys.exit(harness.main(sys.argv[1:], harness.process_start()))
