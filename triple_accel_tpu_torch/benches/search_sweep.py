"""Sweep of kernels K2 (`myers_search`), K6 (`blocked_search`) and K7
(`search_diag`) over the owned length per segment.

    python3 -m triple_accel_tpu_torch.benches.search_sweep [--mb 128] [--blocked | --diag]

Times the search kernel alone (CUDA events, one warm-up, 9 launches:
median, least and most) for unit and restricted-Damerau costs at several
`own_len`.  K2: the headline haystack (upper-case noise, 24-byte needle,
the 256-byte halo of k = 3), the measurement behind `suggest_own_len`.
K6 (`--blocked`): chip_smoke.py's long-needle input (a 3,000-byte ACGT
needle, the 3,328-byte halo of k = 150), the measurement behind
`suggest_own_len_blocked`.  K7 (`--diag`): the headline haystack and
needle at k = 6 under the two general cost models of chip_smoke.py's
`search_general` phase (halos 28 and 26), the measurement behind
`suggest_own_len_diag`.  Prints the card's name and power limit, then
one JSON line per point.  Needs one CUDA device and `nvcc`; there is no
CPU mode.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys

import numpy as np
import torch

from ..ops.myers_chunked import blocked_search
from ..ops.myers_search import myers_search, prepare_myers_needles
from ..ops.search_common import window_span
from ..ops.search_diag import search_diag

NEEDLE_LEN = 24
HALO = 256
OWN_LENS = (512, 1024, 2048, 4096, 8192, 16384)
BLOCKED_NEEDLE_LEN, BLOCKED_HALO = 3000, 3328
BLOCKED_OWN_LENS = (13_312, 26_624, 32_000, 65_536, 131_072)
DIAG_K, DIAG_COSTS = 6, ((2, 1, 2, 0, False), (3, 2, 1, 2, True))
DIAG_OWN_LENS = (1024, 2048, 4096, 8192, 16384, 32768)


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
    ap.add_argument("--blocked", action="store_true",
                    help="sweep K6 on a long needle instead of K2")
    ap.add_argument("--diag", action="store_true",
                    help="sweep K7 under general costs instead of K2")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("search_sweep needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    n = args.mb << 20
    rng = np.random.default_rng(1234)
    if args.blocked:
        acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
        m, halo, own_lens, search = (BLOCKED_NEEDLE_LEN, BLOCKED_HALO,
                                     BLOCKED_OWN_LENS, blocked_search)
        needle = acgt[rng.integers(0, 4, m)]
        hay = torch.from_numpy(acgt[rng.integers(0, 4, n, dtype=np.uint8)])
    else:
        m, halo, own_lens, search = NEEDLE_LEN, HALO, OWN_LENS, myers_search
        needle = rng.integers(97, 123, m).astype(np.uint8)
        hay = torch.from_numpy(rng.integers(65, 91, n).astype(np.uint8))
    hay = hay.to(dev)
    nd = prepare_myers_needles([needle], m, device=dev)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    if args.diag:
        for ct in DIAG_COSTS:
            halo = window_span(m, DIAG_K, ct[1], ct[2])
            for own in DIAG_OWN_LENS:
                print(json.dumps({
                    "kernel": "search_diag", "haystack_bytes": n,
                    "needle_len": m, "k": DIAG_K, "costs": list(ct),
                    "halo": halo, "own_len": own,
                    "segments": -(-n // own),
                    "kernel_ms_median_min_max": _time_ms(
                        lambda: search_diag(hay, nd[0], own_len=own,
                                            halo=halo, costs_t=ct)),
                }), flush=True)
        return 0
    for damerau in (False, True):
        for own in own_lens:
            print(json.dumps({
                "kernel": search.__name__, "haystack_bytes": n,
                "needle_len": m, "halo": halo, "damerau": damerau,
                "own_len": own, "segments": -(-n // own),
                "kernel_ms_median_min_max": _time_ms(lambda: search(
                    hay, nd, own_len=own, halo=halo, damerau=damerau)),
            }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
