"""Run one benchmark cell once and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> \
        --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with the CUDA cards the cell
asks for. The last line of standard output is the result (JSON); the
numbers the run compared with the reference, each beside its limit, are
the last lines of standard error. Without the cards, or if JAX was loaded,
it exits 2 and prints no result.
"""

import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from benchmark import harness  # noqa: E402

harness.prepare_environment(REPO)

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T_START))
