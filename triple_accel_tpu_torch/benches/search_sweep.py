"""Sweep of kernel K2 (`myers_search`) over the owned length per segment.

    python3 -m triple_accel_tpu_torch.benches.search_sweep [--mb 128]

Times the search kernel alone (CUDA events, one warm-up, 9 launches:
median, least and most) on the headline haystack (upper-case noise, 24-byte
needle, the 256-byte halo of k = 3) for unit and restricted-Damerau costs
at several `own_len`; this is the measurement behind `suggest_own_len`.
Prints the card's name and power limit, then one JSON line per point.
Needs one CUDA device and `nvcc`; there is no CPU mode.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys

import numpy as np
import torch

from ..ops.myers_search import myers_search, prepare_myers_needles

NEEDLE_LEN = 24
HALO = 256
OWN_LENS = (512, 1024, 2048, 4096, 8192, 16384)


def _time_ms(fn, reps: int = 9):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        torch.cuda.synchronize()
        times.append(t0.elapsed_time(t1))
    return [round(statistics.median(times), 4), round(min(times), 4),
            round(max(times), 4)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mb", type=int, default=128, help="haystack MiB")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("search_sweep needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    n = args.mb << 20
    rng = np.random.default_rng(1234)
    needle = rng.integers(97, 123, NEEDLE_LEN).astype(np.uint8)
    hay = torch.from_numpy(rng.integers(65, 91, n).astype(np.uint8)).to(dev)
    nd = prepare_myers_needles([needle], NEEDLE_LEN, device=dev)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    for damerau in (False, True):
        for own in OWN_LENS:
            print(json.dumps({
                "haystack_bytes": n, "needle_len": NEEDLE_LEN, "halo": HALO,
                "damerau": damerau, "own_len": own, "segments": -(-n // own),
                "kernel_ms_median_min_max": _time_ms(lambda: myers_search(
                    hay, nd, own_len=own, halo=HALO, damerau=damerau)),
            }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
