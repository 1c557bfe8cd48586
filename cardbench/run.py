"""Run one cell of the benchmark: ``python3 cardbench/run.py --workload
<name> --seed <n> --seconds <s> --trace <0|1>`` from the root of a
checkout. Prints the result as one JSON line, last on standard output,
and each number compared beside its limit last on standard error."""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the checkout's root and its ``src`` in place of this file's directory
sys.path[0:1] = [ROOT, os.path.join(ROOT, "src")]

if __name__ == "__main__":
    from cardbench import harness
    sys.exit(harness.main(sys.argv[1:], T_START))
