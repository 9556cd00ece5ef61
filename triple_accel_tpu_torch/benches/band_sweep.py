"""Sweep of the band kernels K3 / K4 over the band cells a thread walks.

    python3 -m triple_accel_tpu_torch.benches.band_sweep

Times `band_distance` and `band_trace` alone (CUDA events, one warm-up, 5
launches: median, least and most) at the four shapes `chip_smoke.py`
drives (short and long regime of each), once for every value of
`lev_band.CELLS_PER_THREAD` in `CELLS`; `band_plan` turns the value into
the block's thread count.  This is the measurement behind that constant.
Pairs are random bytes with every 50th character replaced, equal lengths:
the kernel's work does not depend on the data.  Prints the card's name and
power limit, then one JSON line per point.  Needs one CUDA device and
`nvcc`; there is no CPU mode.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys

import torch

from ..ops import lev_band as lb

CELLS = (1, 2, 4, 8, 16)
RDAMERAU_T = (1, 1, 0, 1, True)
AFFINE_T = (2, 1, 2, 0, False)
# (name, traced, pairs, string length, unit_k, costs)
SHAPES = (
    ("band_distance", False, 196_608, 1000, 32, RDAMERAU_T),
    ("band_distance_long", False, 4096, 20_000, 256, AFFINE_T),
    ("band_trace", True, 8192, 1000, 32, RDAMERAU_T),
    ("band_trace_long", True, 256, 3000, 64, RDAMERAU_T),
)


def _time_ms(fn, reps: int = 5):
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


def _make_batch(dev, pairs: int, length: int, unit_k: int):
    gen = torch.Generator(device=dev).manual_seed(1234)
    W = 2 * unit_k + 1
    rows = -(-length // 16) * 16
    a_t = torch.zeros((pairs, rows), dtype=torch.uint8, device=dev)
    a_t[:, :length] = torch.randint(97, 123, (pairs, length), generator=gen,
                                    dtype=torch.uint8, device=dev)
    b_t = torch.zeros((pairs, rows + W), dtype=torch.uint8, device=dev)
    b_t[:, unit_k:unit_k + length] = a_t[:, :length]
    b_t[:, unit_k:unit_k + length:50] = 65
    m = torch.full((pairs,), length, dtype=torch.int32, device=dev)
    return a_t, b_t, m, m.clone()


def main() -> int:
    if not torch.cuda.is_available():
        print("band_sweep needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    chosen = lb.CELLS_PER_THREAD
    try:
        for name, traced, pairs, length, unit_k, costs_t in SHAPES:
            tensors = _make_batch(dev, pairs, length, unit_k)
            fn = lb.band_trace if traced else lb.band_distance
            first = None
            for cells in CELLS:
                lb.CELLS_PER_THREAD = cells
                plan = lb.band_plan(tensors[0].shape[1], unit_k, traced)
                res = fn(*tensors, unit_k=unit_k, costs_t=costs_t)
                dist = (res[0] if traced else res).cpu()
                if first is None:
                    first = dist
                print(json.dumps({
                    "kernel": name, "pairs": pairs, "str_len": length,
                    "band": 2 * unit_k + 1, "cells_per_thread_asked": cells,
                    "threads": plan["threads"],
                    "cells_per_thread": plan["cells_per_thread"],
                    "same_distances": bool(torch.equal(dist, first)),
                    "kernel_ms_median_min_max": _time_ms(lambda: fn(
                        *tensors, unit_k=unit_k, costs_t=costs_t)),
                }), flush=True)
                del res
            del tensors
            torch.cuda.empty_cache()
    finally:
        lb.CELLS_PER_THREAD = chosen
    return 0


if __name__ == "__main__":
    sys.exit(main())
