"""One run of one benchmark cell; see ``harness.py``.

    python3 stitchbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Prints the result as one JSON object on the last line of standard output,
and the set-up's parts and each compared number beside its limit as the
last lines of standard error.
"""
import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the checkout's root (for ``stitchbench``) and its ``src`` (for the port),
# in place of this script's own directory
sys.path[0:1] = [ROOT, os.path.join(ROOT, "src")]

if __name__ == "__main__":
    from stitchbench import harness

    sys.exit(harness.main(sys.argv[1:], T0))
