"""Readings for the check's limits: runs a cell once per seed, in one
process, with the control in the program's place, and prints one JSON
line a seed: `correct` and `checks` judge the control's numbers by the
committed limits, and `readings` hold the program's own numbers of the
same run.

    python3 stcbench/calibrate.py --workload <cell> --seeds 11,12,13 \
        --seconds 10

The control is the plain reference computed in the nearest precision
below the configuration's (reference/precision.py).  The benchmark's own
runs never compute it.
"""

import argparse
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from stcbench import harness  # noqa: E402


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 3
    torch.set_num_threads(1)
    spec = harness.resolve(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        r = harness.run_cell(spec, seed, args.seconds, False, "cuda", t0,
                             control=True)
        r.update(seed=seed, workload=args.workload,
                 call_s=time.perf_counter() - t0)
        print(json.dumps(r), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
