"""Readings of the control of `correct`: the cell's control (its kind's
`open_control`: the plain reference with one of the configuration's
guarantees broken) put in the program's place and driven through the
harness's own run (`run_cell(control=True)`): the same set-up, window,
sample and comparison as a benchmark run.  Each run prints its result;
`correct` has to read false, and its `mismatched_answers` is the upper
reading the limit (0) lies below.

    python3 portbench/tools/control.py --cells wfa10k.exact --seeds 1 2 3 \\
        --seconds 2
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--cells", nargs="+", required=True)
    p.add_argument("--seeds", nargs="+", type=int, required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args()
    from portbench.harness import find_cell, run_cell

    for name in args.cells:
        for seed in args.seeds:
            t0 = time.perf_counter()
            r = run_cell(find_cell(name), seed, args.seconds, False,
                         device=args.device, control=True,
                         emit=lambda s: None)
            print(json.dumps({"cell": name, "seed": seed, "control": True,
                              "correct": r["correct"],
                              "attempted": r["attempted"],
                              "checks": r["checks"],
                              "wall_s": time.perf_counter() - t0}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
