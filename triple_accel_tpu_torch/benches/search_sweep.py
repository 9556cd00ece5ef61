"""Sweep of kernels K2 (`myers_search`), K6 (`blocked_search`) and K7
(`search_diag`) over the owned length per segment and their lane maps,
and of K8 (`flat_search`) and K9 (`flat_distance`) over their launch
shape.

    python3 -m triple_accel_tpu_torch.benches.search_sweep [--mb 128]
        [--blocked | --diag | --cap | --flat | --long | --many]

Times the search kernel alone (CUDA events, one warm-up, 9 launches:
median, least and most) for unit and restricted-Damerau costs at several
`own_len`.  K2: the headline haystack (upper-case noise, 24-byte needle,
k = 3: a window span of 27) at two halos (32: the span rounded up to 32,
`search_halo`; 256: the JAX package's quantum) x `own_len` x warps a
block (`--own-lens`, `--warps` pick points): the measurement behind
`search_halo`, `suggest_own_len` and `WARPS`.  `--long`: K2 at its plan
against K6 at its plan for needles of 64 to 1,280 chars (`--lens`) over a
16 MiB ACGT haystack at k = m / 8, both cost models: the measurement
behind the search dispatch's route from K2 to K6 (`ROUTE_MAX_NEEDLE`).
K6 (`--blocked`): chip_smoke.py's long-needle input (a 3,000-byte ACGT
needle at k = 150 and k = 1000: halos 3,328 and 4,096) over the lane maps
that hold its 94 words (32 lanes x 3 words, 16 x 6, 8 x 12) x warps a
block x `own_len`, unit and restricted-Damerau, 5 launches a point, then
anchored (one segment of 4,000 columns) at each map: the measurement
behind `blocked_plan`'s SEARCH_LANES_ORDER and SEARCH_WARPS and
`suggest_own_len_blocked`.  K7 (`--diag`): the headline haystack and
needle at k = 6 and k = 30 under the two general cost models of
chip_smoke.py's `search_general` phase (halos 28 / 26 and 52 / 38) over
the lane maps of 24 rows (8 lanes x 3 rows, 4 x 6, 16 x 2, 32 x 1) x
warps a block x `own_len`: the measurement behind `diag_plan`'s
LANES_ORDER and WARPS and `suggest_own_len_diag`.  `--cap`: K7 at its plan
and at 32 lanes (8, 12, 16 rows) against K8 for needles of 256, 384 and
512 chars over a 16 MiB ACGT haystack at k = m / 8, both cost models: the
measurement behind `K7_MAX_NEEDLE`.  K8 and K9 (`--flat`): chip_smoke.py's
`flat_search` and `flat_distance` shapes (a 3,000-byte ACGT needle over
16 MiB at k = 150 under its two cost models; 256 pairs of 20,000 ACGT
bytes with 10% substitutions under affine costs, the full matrix) over
threads a block x columns a lane, and K8 over its owned length (1 to 4
blocks an SM in one wave), 5 launches a point: the measurement behind
`SEARCH_SHAPES` (one shape for each of K8's two kernel variants),
`DIST_COLS` and `DIST_MAX_THREADS`.  `--many`: dictionary search end to
end (`levenshtein_search_many`, All mode, on a resident `PackedHaystack`)
of MANY_NEEDLES 24-char needles at k = 3 over the headline haystack, by
needles a launch (`--counts`; `_MANY_LAUNCH_BYTES` set for each), 3 calls
a point: the measurement behind `_MANY_LAUNCH_BYTES`.  Prints the card's
name and power limit, then one JSON line per point.  Needs one CUDA device and `nvcc`;
there is no CPU mode.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys

import numpy as np
import torch

from ..ops.myers_chunked import blocked_search, suggest_own_len_blocked
from ..ops.myers_search import (myers_search, prepare_myers_needles,
                                search_halo, suggest_own_len)
from ..ops.search_common import window_span
from ..ops import search_flat as sf
from ..ops.search_diag import ROW_CHOICES, diag_plan, search_diag

NEEDLE_LEN = 24
K2_HALOS = (32, 256)
K2_OWN_LENS = (512, 1024, 1536, 2048, 3072, 4096, 8192)
K2_WARPS = (2, 4, 8)
LONG_MB, LONG_LENS = 16, (64, 128, 256, 400, 640, 1280)
BLOCKED_NEEDLE_LEN, BLOCKED_KS = 3000, (150, 1000)
BLOCKED_MAPS = ((32, 3), (16, 6), (8, 12))  # lanes, words a lane: 94 words
BLOCKED_WARPS = (2, 4, 8)
BLOCKED_OWN_HALOS = (4, 8, 16)  # owned length in halos
BLOCKED_ANCHORED_COLS = 4000
DIAG_KS, DIAG_COSTS = (6, 30), ((2, 1, 2, 0, False), (3, 2, 1, 2, True))
DIAG_MAPS = ((8, 3), (4, 6), (16, 2), (32, 1))  # lanes, rows a lane
DIAG_WARPS = (2, 4, 8)
DIAG_OWN_LENS = (1024, 2048, 4096, 8192)
CAP_MB, CAP_LENS = 16, (256, 384, 512)
FLAT_MB, FLAT_NEEDLE_LEN, FLAT_K = 16, 3000, 150
FLAT_COSTS = ((2, 1, 2, 0, False), (3, 2, 1, 2, True))
FLAT_PAIRS, FLAT_PAIR_LEN, FLAT_SUB_SHARE = 256, 20_000, 0.1
FLAT_THREADS, FLAT_COLS = (128, 256, 512), (4, 8, 16)
FLAT_BLOCKS_PER_SM = (1, 2, 3, 4)
MANY_NEEDLES, MANY_COUNTS = 120, (1, 2, 4, 8, 12, 15)


def _smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


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


def flat_sweep(dev, rng) -> None:
    """K8 and K9 over threads x columns a lane (those the kernel takes),
    K8 also over the blocks an SM its segments ask for, each cost model
    on its own kernel variant's shape."""
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    n = FLAT_MB << 20
    hay = torch.from_numpy(acgt[rng.integers(0, 4, n)]).to(dev)
    nd = torch.from_numpy(acgt[rng.integers(0, 4, FLAT_NEEDLE_LEN)]).to(dev)
    a = acgt[rng.integers(0, 4, (FLAT_PAIRS, FLAT_PAIR_LEN))]
    b = a.copy()
    hit = rng.random(b.shape) < FLAT_SUB_SHARE
    b[hit] = acgt[(rng.integers(1, 4, int(hit.sum()))
                   + np.searchsorted(acgt, b[hit])) % 4]
    pairs = sf.prepare_flat_distance_inputs(list(a), list(b), device=dev)
    saved = (dict(sf.SEARCH_SHAPES), sf.DIST_COLS, sf.DIST_MAX_THREADS)
    try:
        for cols in FLAT_COLS:
            for threads in FLAT_THREADS:
                if threads <= sf.max_threads(False, cols):
                    sf.DIST_COLS, sf.DIST_MAX_THREADS = cols, threads
                    print(json.dumps({
                        "kernel": "flat_distance", "pairs": FLAT_PAIRS,
                        "str_len": FLAT_PAIR_LEN, "costs": list(FLAT_COSTS[0]),
                        "threads": threads, "cols": cols,
                        "strip": threads * cols,
                        "kernel_ms_median_min_max": _time_ms(
                            lambda: sf.flat_distance(
                                *pairs, costs_t=FLAT_COSTS[0]), 5),
                    }), flush=True)
                if threads > sf.max_threads(True, cols):
                    continue
                for ct in FLAT_COSTS:
                    halo = window_span(FLAT_NEEDLE_LEN, FLAT_K, ct[1], ct[2])
                    for per_sm in FLAT_BLOCKS_PER_SM:
                        sf.SEARCH_SHAPES[ct[4]] = (threads, cols, per_sm)
                        own = sf.suggest_own_len_flat(n, halo,
                                                      transpose=ct[4])
                        print(json.dumps({
                            "kernel": "flat_search", "haystack_bytes": n,
                            "needle_len": FLAT_NEEDLE_LEN, "k": FLAT_K,
                            "costs": list(ct), "halo": halo,
                            "threads": threads, "cols": cols,
                            "blocks_per_sm": per_sm, "own_len": own,
                            "segments": -(-n // own),
                            "kernel_ms_median_min_max": _time_ms(
                                lambda: sf.flat_search(
                                    hay, nd, own_len=own, halo=halo,
                                    costs_t=ct), 5),
                        }), flush=True)
    finally:
        shapes, sf.DIST_COLS, sf.DIST_MAX_THREADS = saved
        sf.SEARCH_SHAPES.update(shapes)


def blocked_sweep(dev, rng, n: int) -> None:
    """K6 over lane maps x warps a block x owned length at two halos, unit
    and restricted-Damerau; then anchored at each map."""
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    m = BLOCKED_NEEDLE_LEN
    needle = acgt[rng.integers(0, 4, m)]
    hay = torch.from_numpy(acgt[rng.integers(0, 4, n, dtype=np.uint8)])
    hay = hay.to(dev)
    nd = prepare_myers_needles([needle], m, device=dev)
    for k in BLOCKED_KS:
        halo = -(-window_span(m, k, 1, 0) // 256) * 256
        for lanes, wpt in BLOCKED_MAPS:
            for warps in BLOCKED_WARPS:
                plan = {"words_per_lane": wpt, "lanes": lanes,
                        "warps": warps}
                for per in BLOCKED_OWN_HALOS:
                    own = per * halo
                    for damerau in (False, True):
                        print(json.dumps({
                            "kernel": "blocked_search", "haystack_bytes": n,
                            "needle_len": m, "k": k, "halo": halo,
                            "lanes": lanes, "words_per_lane": wpt,
                            "warps": warps, "own_len": own,
                            "segments": -(-n // own), "damerau": damerau,
                            "kernel_ms_median_min_max": _time_ms(
                                lambda: blocked_search(
                                    hay, nd, own_len=own, halo=halo,
                                    damerau=damerau, plan=plan), 5),
                        }), flush=True)
    cols = BLOCKED_ANCHORED_COLS
    for lanes, wpt in BLOCKED_MAPS:
        plan = {"words_per_lane": wpt, "lanes": lanes, "warps": 1}
        print(json.dumps({
            "kernel": "blocked_search", "anchored": True, "columns": cols,
            "needle_len": m, "lanes": lanes, "words_per_lane": wpt,
            "kernel_ms_median_min_max": _time_ms(
                lambda: blocked_search(hay[:cols], nd, own_len=cols, halo=0,
                                       anchored=True, plan=plan)),
        }), flush=True)


def diag_sweep(hay, nd) -> None:
    """K7 over lane maps x warps a block x owned length at two halos a cost
    model."""
    m = nd.shape[0]
    for ct in DIAG_COSTS:
        for k in DIAG_KS:
            halo = window_span(m, k, ct[1], ct[2])
            for lanes, rows in DIAG_MAPS:
                for warps in DIAG_WARPS:
                    plan = {"rows_per_lane": rows, "lanes": lanes,
                            "warps": warps}
                    for own in DIAG_OWN_LENS:
                        print(json.dumps({
                            "kernel": "search_diag", "haystack_bytes":
                                hay.shape[0], "needle_len": m, "k": k,
                            "costs": list(ct), "halo": halo, "lanes": lanes,
                            "rows_per_lane": rows, "warps": warps,
                            "own_len": own,
                            "segments": -(-hay.shape[0] // own),
                            "kernel_ms_median_min_max": _time_ms(
                                lambda: search_diag(hay, nd, own_len=own,
                                                    halo=halo, costs_t=ct,
                                                    plan=plan), 5),
                        }), flush=True)


def cap_sweep(dev, rng) -> None:
    """K7 (its plan, and 32 lanes at the fewest rows that hold the needle)
    against K8 for needles of CAP_LENS chars on one haystack, both cost
    models."""
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    n = CAP_MB << 20
    hay = torch.from_numpy(acgt[rng.integers(0, 4, n)]).to(dev)
    for m in CAP_LENS:
        nd = torch.from_numpy(acgt[rng.integers(0, 4, m)]).to(dev)
        k = m // 8
        for ct in DIAG_COSTS:
            halo = window_span(m, k, ct[1], ct[2])
            own7 = max(16 * (halo + 32), 2048)
            own8 = sf.suggest_own_len_flat(n, halo, transpose=ct[4])
            runs = {"flat_search": lambda: sf.flat_search(
                hay, nd, own_len=own8, halo=halo, costs_t=ct)}
            wide = {"rows_per_lane": next(r for r in ROW_CHOICES
                                          if 32 * r >= m),
                    "lanes": 32, "warps": diag_plan(m)["warps"]}
            for plan in [diag_plan(m)] + [wide] * (wide != diag_plan(m)):
                runs[f"search_diag {plan['lanes']}x{plan['rows_per_lane']}"
                     ] = (lambda plan=plan: search_diag(
                         hay, nd, own_len=own7, halo=halo, costs_t=ct,
                         plan=plan))
            for name, fn in runs.items():
                print(json.dumps({
                    "kernel": name, "haystack_bytes": n, "needle_len": m,
                    "k": k, "costs": list(ct), "halo": halo,
                    "own_len": own8 if name == "flat_search" else own7,
                    "kernel_ms_median_min_max": _time_ms(fn, 5),
                }), flush=True)


def long_sweep(dev, rng, lens) -> None:
    """K2 against K6, each at its own plan, over needle lengths."""
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    n = LONG_MB << 20
    hay = torch.from_numpy(acgt[rng.integers(0, 4, n)]).to(dev)
    for m in lens:
        nd = prepare_myers_needles([acgt[rng.integers(0, 4, m)]], m,
                                   device=dev)
        span = window_span(m, m // 8, 1, 0)
        h2 = search_halo(span, n)
        h6 = min(-(-span // 256) * 256, n)
        plans = {"myers_search": (myers_search, h2, suggest_own_len(n, h2)),
                 "blocked_search": (blocked_search, h6,
                                    suggest_own_len_blocked(n, h6))}
        for damerau in (False, True):
            for name, (fn, halo, own) in plans.items():
                print(json.dumps({
                    "kernel": name, "haystack_bytes": n, "needle_len": m,
                    "k": m // 8, "halo": halo, "own_len": own,
                    "damerau": damerau,
                    "kernel_ms_median_min_max": _time_ms(
                        lambda: fn(hay, nd, own_len=own, halo=halo,
                                   damerau=damerau), 5),
                }), flush=True)


def many_sweep(dev, rng, n: int, counts) -> None:
    """Dictionary search end to end by needles a launch."""
    import importlib
    import time

    from ..types import SearchType

    lev = importlib.import_module("triple_accel_tpu_torch.levenshtein")
    hay = rng.integers(65, 91, n).astype(np.uint8)
    needles = [rng.integers(97, 123, NEEDLE_LEN).astype(np.uint8)
               for _ in range(MANY_NEEDLES)]
    for i in range(0, MANY_NEEDLES, 4):  # a planted copy every 4th needle
        pos = int(rng.integers(0, n - NEEDLE_LEN))
        hay[pos: pos + NEEDLE_LEN] = needles[i]
    ph = lev.PackedHaystack(hay, device=dev)
    ph.device_haystack()
    per_needle = 4 * (n + 32) + n + 1  # _many_launch_plan's K2 bytes
    saved = lev._MANY_LAUNCH_BYTES
    try:
        for c in counts:
            lev._MANY_LAUNCH_BYTES = c * per_needle
            lev.levenshtein_search_many(needles[:c], ph, 3, SearchType.All)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            times = []
            for _ in range(3):
                t0 = time.perf_counter()
                lev.levenshtein_search_many(needles, ph, 3, SearchType.All)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            med = statistics.median(times)
            print(json.dumps({
                "kernel": "myers_search (dictionary)", "haystack_bytes": n,
                "needles": MANY_NEEDLES, "needle_len": NEEDLE_LEN, "k": 3,
                "needles_a_launch": c,
                "launches": len(lev._many_launch_plan(
                    MANY_NEEDLES, n, False, 32, 2048)),
                "e2e_s_median_min_max": [round(med, 4),
                                         round(min(times), 4),
                                         round(max(times), 4)],
                "needles_per_s": round(MANY_NEEDLES / med, 1),
                "peak_device_MB": round(
                    torch.cuda.max_memory_allocated() / 2**20),
            }), flush=True)
    finally:
        lev._MANY_LAUNCH_BYTES = saved


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mb", type=int, default=128, help="haystack MiB")
    ap.add_argument("--blocked", action="store_true",
                    help="sweep K6 on a long needle instead of K2")
    ap.add_argument("--diag", action="store_true",
                    help="sweep K7 under general costs instead of K2")
    ap.add_argument("--cap", action="store_true",
                    help="time K7 against K8 at 256 to 512 chars instead")
    ap.add_argument("--flat", action="store_true",
                    help="sweep K8 and K9 over their launch shape instead")
    ap.add_argument("--long", action="store_true",
                    help="time K2 against K6 over needle lengths instead")
    ap.add_argument("--many", action="store_true",
                    help="time dictionary search by needles a launch")
    ap.add_argument("--counts", type=int, nargs="+", default=MANY_COUNTS,
                    help="--many: the needles a launch to time")
    ap.add_argument("--lens", type=int, nargs="+", default=LONG_LENS,
                    help="--long: the needle lengths to time")
    ap.add_argument("--own-lens", type=int, nargs="+", default=K2_OWN_LENS,
                    help="K2: the owned lengths to time")
    ap.add_argument("--warps", type=int, nargs="+", default=K2_WARPS,
                    help="K2: the warps a block to time")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("search_sweep needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    n = args.mb << 20
    rng = np.random.default_rng(1234)
    print(_smi(), flush=True)
    if args.flat:
        flat_sweep(dev, rng)
        return 0
    if args.blocked:
        blocked_sweep(dev, rng, n)
        return 0
    if args.cap:
        cap_sweep(dev, rng)
        return 0
    if args.long:
        long_sweep(dev, rng, args.lens)
        return 0
    if args.many:
        many_sweep(dev, rng, n, args.counts)
        return 0
    m = NEEDLE_LEN
    needle = rng.integers(97, 123, m).astype(np.uint8)
    hay = torch.from_numpy(rng.integers(65, 91, n).astype(np.uint8)).to(dev)
    nd = prepare_myers_needles([needle], m, device=dev)
    if args.diag:
        diag_sweep(hay, nd[0])
        return 0
    for damerau in (False, True):
        for halo in K2_HALOS:
            for warps in args.warps:
                for own in args.own_lens:
                    print(json.dumps({
                        "kernel": "myers_search", "haystack_bytes": n,
                        "needle_len": m, "halo": halo, "damerau": damerau,
                        "warps": warps, "own_len": own,
                        "segments": -(-n // own),
                        "kernel_ms_median_min_max": _time_ms(
                            lambda: myers_search(
                                hay, nd, own_len=own, halo=halo,
                                damerau=damerau, warps=warps)),
                    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
