"""Run one cell of the benchmark once and print its result line.

    python3 stcbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout on a machine with the CUDA cards the cell
asks for (BENCHMARK.json).  The last line of standard output is one JSON
object; the numbers the check compared, each with its limit, are the last
lines of standard error.  Exits non-zero, printing no result, without
enough cards or when JAX or the JAX package got loaded.
"""

import faulthandler
import os
import sys
import time

T_START = time.perf_counter()
faulthandler.enable()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
os.environ.setdefault("USE_FLAX", "0")

from stcbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T_START))
