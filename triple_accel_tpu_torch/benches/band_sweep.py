"""Sweep of the band kernels K3 / K4 over their launch plan.

    python3 -m triple_accel_tpu_torch.benches.band_sweep [--chosen]
    python3 -m triple_accel_tpu_torch.benches.band_sweep --past-plan
    python3 -m triple_accel_tpu_torch.benches.band_sweep --walk
    python3 -m triple_accel_tpu_torch.benches.band_sweep --wide

Times `band_distance` and `band_trace` alone (CUDA events, one warm-up, 5
launches: median, least and most) at the four shapes `chip_smoke.py`
drives (short and long regime of each) and at a small untraced batch (256
pairs, band 129), for every lane map of the warp regime that holds the band
(`lev_band.WARP_CELLS` cells a lane x `WARP_LANES` lanes a pair) at each of
`THREADS` threads a block; the point `band_plan` picks for the shape is
marked `"chosen": true`.  This is the measurement behind `lev_band`'s
`_warp_map`, `FULL_THREADS` and `SMALL_BATCH_WARPS`.  With `--chosen`, only
the chosen points (the kernel's times for an A/B between two versions in
one call).  Pairs are random bytes with every 50th character replaced,
equal lengths: the kernel's work does not depend on the data.  Every point
must give the first point's distances.  Prints the card's name and power
limit, then one JSON line per point.  Needs one CUDA device and `nvcc`;
there is no CPU mode.

With `--past-plan`, only K4 past the band plan, in its cluster regime, at
`PAST_PLAN_SHAPES`: the shape of `chip_smoke.py`'s `past_plan` phase (128
pairs of 10,000 bytes at an unbounded threshold: unit_k 10,000, band
20,001: one strip a warp) over `CLUSTER_POINTS` (CTAs a cluster x warps a
CTA that hold the 10,003 columns), and those of its `band_wide` cases (e)
and (f) (2 and 64 pairs of 90,000 bytes at unit_k 5,008, band 10,017: 176
strips, of which 21 meet a row) over `RING_POINTS` (16 to 32 warps in the
ring); the plan's point first, 3 timed launches each; `--pairs N` runs N
pairs of each instead (1: the single-pair call).  Every point must give
the first point's distances and codes.  This is the measurement behind
`lev_band.CLUSTER_WARPS`, `CLUSTER_SPREAD_WARPS` and `_cluster_map`.

With `--wide`, only the block regime (bands past 544 cells) at
`WIDE_BANDS` (545 cells, the bands the untraced engines run, and the
widest traced one), untraced under rDamerau costs and traced, each at a
batch that fills the card (`WIDE_FULL_PAIRS` pairs, `WIDE_TRACE_PAIRS`
traced) and at one pair, over `lev_band.BLOCK_CELLS` cells a lane at the
fewest warps a pair that hold the band (the plan's point first), 5 timed
launches each.  This is the measurement behind `lev_band.NINE_CELL_WARPS`.

With `--walk`, only the walk kernel K10 at the three traced cells of
`chip_smoke.py`'s `band_trace` phase (its inputs, K4's codes at the band
the traced dispatch picks: `kernel_ab.traced_cells`) over `WALK_POINTS`
(lanes a pair x rows a tile x words a window, `WALK_THREADS` threads a
block; the plan's point first; points the launcher refuses, whose tiles
pass a block's shared memory, are left out), 9 timed launches of the
walk kernel alone each,
and of the whole wrapper at the plan's point; every point must give the
plan's run counts.  This is the measurement behind `trace_walk.walk_plan`.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys

import torch

from ..ops import lev_band as lb

THREADS = (32, 64, 128, 256)
RDAMERAU_T = (1, 1, 0, 1, True)
AFFINE_T = (2, 1, 2, 0, False)
# (name, traced, pairs, string length, unit_k, costs)
SHAPES = (
    ("band_distance", False, 196_608, 1000, 32, RDAMERAU_T),
    ("band_distance_long", False, 4096, 20_000, 256, AFFINE_T),
    ("band_trace", True, 8192, 1000, 32, RDAMERAU_T),
    ("band_trace_long", True, 256, 3000, 64, RDAMERAU_T),
    ("band_distance_small", False, 256, 3000, 64, AFFINE_T),
)
PAST_PLAN_SHAPES = (
    ("band_trace_past_plan", True, 128, 10_000, 10_000, RDAMERAU_T),
    ("band_trace_ring_e", True, 2, 90_000, 5008, RDAMERAU_T),
    ("band_trace_ring_f", True, 64, 90_000, 5008, RDAMERAU_T),
)
# the block regime: bands, rows a pair, pairs that fill the card
WIDE_BANDS = (545, 1025, 2049, 4097, 8193, 9281)
WIDE_LEN, WIDE_FULL_PAIRS, WIDE_TRACE_PAIRS = 2000, 1024, 256
# (CTAs a cluster, warps a CTA): the fewest warps that hold 10,003 columns
# at each cluster size, and one warp more
CLUSTER_POINTS = tuple((c, w + e) for c in range(2, 9)
                       for w in (-(-20 // c),) for e in (0, 1)
                       if w + e <= lb.CLUSTER_MAX_WARPS)
# (CTAs a cluster, warps a CTA) of the ring past a cluster's columns: 16,
# 20, 21, 24, 25, 28 and 32 warps (21 strips meet a row of band 10,017)
RING_POINTS = ((4, 4), (8, 2), (2, 10), (5, 4), (4, 5), (1, 20), (3, 7),
               (7, 3), (6, 4), (4, 6), (3, 8), (8, 3), (5, 5), (4, 7),
               (7, 4), (8, 4), (4, 8), (2, 16))


WALK_POINTS = tuple((lanes, rows, window) for lanes in (4, 8, 16, 32)
                    for rows in (16, 32, 64, 128) for window in (2, 4, 8, 16))
WALK_THREADS = (64, 128, 256)


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


def _plans(rows: int, unit_k: int, traced: bool, pairs: int, only_chosen,
           max_n: int):
    """The chosen plan first, then every other plan of its regime: the
    cluster's at CLUSTER_POINTS where a warp a strip holds the columns,
    else at RING_POINTS."""
    chosen = lb.band_plan(rows, unit_k, traced, batch=pairs, max_n=max_n)
    out = [chosen]
    W = 2 * unit_k + 1
    if chosen["regime"] == "wide_cluster" and not only_chosen:
        strips = -(-(max_n + 3) // 512)
        one_each = strips <= chosen["warps_per_pair"]
        for ctas, warps in CLUSTER_POINTS if one_each else RING_POINTS:
            plan = dict(chosen, ctas_per_pair=ctas, threads=32 * warps,
                        warps_per_pair=ctas * warps,
                        lanes_per_pair=32 * ctas * warps)
            if plan != chosen and (not one_each
                                   or ctas * warps >= strips):
                out.append(plan)
    if only_chosen or chosen["regime"] != "warp":
        return out
    for cells in lb.WARP_CELLS:
        for lanes in lb.WARP_LANES:
            for threads in THREADS:
                if cells * lanes < W:
                    continue
                plan = dict(chosen, cells_per_lane=cells,
                            lanes_per_pair=lanes, threads=threads,
                            pairs_per_block=threads // lanes)
                if plan != chosen:
                    out.append(plan)
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    only_chosen = "--chosen" in argv
    if not torch.cuda.is_available():
        print("band_sweep needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    if "--walk" in argv:
        return _walk_sweep(dev)
    if "--wide" in argv:
        return _wide_sweep(dev)
    past_plan = "--past-plan" in argv
    shapes = PAST_PLAN_SHAPES if past_plan else SHAPES
    if past_plan and "--pairs" in argv:
        n_pairs = int(argv[argv.index("--pairs") + 1])
        shapes = tuple(x[:2] + (n_pairs,) + x[3:] for x in shapes)
    for name, traced, pairs, length, unit_k, costs_t in shapes:
        tensors = _make_batch(dev, pairs, length, unit_k)
        fn = lb.band_trace if traced else lb.band_distance
        first = first_codes = None
        for k, plan in enumerate(_plans(tensors[0].shape[1], unit_k, traced,
                                        pairs, only_chosen, length)):
            res = fn(*tensors, unit_k=unit_k, costs_t=costs_t, plan=plan)
            dist = (res[0] if traced else res).cpu()
            if first is None:
                first = dist
            extra = {}
            if past_plan:
                if first_codes is None:
                    first_codes = res[1]
                extra["same_codes"] = bool(torch.equal(res[1], first_codes))
                del res
                res = None
            if plan["regime"] == "wide_cluster":
                extra["ctas_per_pair"] = plan["ctas_per_pair"]
                extra["warps_per_pair"] = plan["warps_per_pair"]
            reps = 3 if past_plan else 5
            print(json.dumps({
                "kernel": name, "pairs": pairs, "str_len": length,
                "band": 2 * unit_k + 1, "chosen": k == 0,
                "regime": plan["regime"],
                "cells_per_lane": plan["cells_per_lane"],
                "lanes_per_pair": plan["lanes_per_pair"],
                "threads": plan["threads"],
                "same_distances": bool(torch.equal(dist, first)), **extra,
                "kernel_ms_median_min_max": _time_ms(lambda: fn(
                    *tensors, unit_k=unit_k, costs_t=costs_t, plan=plan),
                    reps),
            }), flush=True)
            del res
        del tensors, first_codes
        torch.cuda.empty_cache()
    return 0


def _wide_sweep(dev) -> int:
    """The block regime over cells a lane at each band, traced or not, at a
    full batch and at one pair; every point gives the plan's distances
    (and codes)."""
    for W in WIDE_BANDS:
        unit_k = (W - 1) // 2
        for traced in (False, True):
            fn = lb.band_trace if traced else lb.band_distance
            full = WIDE_TRACE_PAIRS if traced else WIDE_FULL_PAIRS
            for pairs in (full, 1):
                tensors = _make_batch(dev, pairs, WIDE_LEN, unit_k)
                rows = tensors[0].shape[1]
                chosen = lb.band_plan(rows, unit_k, traced, batch=pairs)
                plans = [chosen] + [
                    dict(chosen, cells_per_lane=c, warps_per_pair=nw,
                         lanes_per_pair=32 * nw, threads=32 * nw)
                    for c in lb.BLOCK_CELLS
                    for nw in (-(-W // (32 * c)),)
                    if nw <= lb.BLOCK_MAX_WARPS[c]
                    and c != chosen["cells_per_lane"]]
                first = None
                for k, plan in enumerate(plans):
                    res = fn(*tensors, unit_k=unit_k, costs_t=RDAMERAU_T,
                             plan=plan)
                    res = res if traced else (res, None)
                    if first is None:
                        first = res
                    same = bool(torch.equal(res[0], first[0])) and (
                        not traced or bool(torch.equal(res[1], first[1])))
                    print(json.dumps({
                        "kernel": "band_trace" if traced else "band_distance",
                        "pairs": pairs, "str_len": WIDE_LEN, "band": W,
                        "chosen": k == 0, "regime": plan["regime"],
                        "cells_per_lane": plan["cells_per_lane"],
                        "warps_per_pair": plan["warps_per_pair"],
                        "same_results": same,
                        "kernel_ms_median_min_max": _time_ms(lambda: fn(
                            *tensors, unit_k=unit_k, costs_t=RDAMERAU_T,
                            plan=plan)),
                    }), flush=True)
                    del res
                del tensors, first
                torch.cuda.empty_cache()
    return 0


def _walk_sweep(dev) -> int:
    """K10 over WALK_POINTS x WALK_THREADS at the three traced cells: the
    walk kernel alone (its run buffer preallocated), the plan's point
    also through the wrapper (the kernel, the running sums of the counts,
    their total read on the host, the gather)."""
    import os

    sys.path.insert(0, os.getcwd())  # chip_smoke.py of the checkout
    import chip_smoke as cs

    from ..ops import trace_walk as tw
    from .kernel_ab import traced_cells

    for name, codes, t, unit_k in traced_cells(cs, dev):
        W = 2 * unit_k + 1
        B = codes.shape[0]
        chosen = tw.walk_plan(W, B)
        steps = tw.walk_steps(t[0].shape[1], unit_k)
        buf = torch.empty((B, steps), dtype=torch.int32, device=dev)
        counts = torch.empty(B, dtype=torch.int32, device=dev)
        tw._launch_walk(codes, *t, unit_k, chosen, buf, counts)
        first = counts.clone()
        print(json.dumps({
            "kernel": name, "band": W, "pairs": B, "wrapper": True,
            **chosen, "ms_median_min_max": _time_ms(
                lambda: tw.trace_walk(codes, *t, unit_k=unit_k), 9)}),
            flush=True)
        points = [chosen] + [
            {"lanes": lanes, "tile_rows": rows, "window": window,
             "threads": threads}
            for lanes, rows, window in WALK_POINTS
            for threads in WALK_THREADS]
        for k, plan in enumerate(points):
            if k and plan == chosen:
                continue
            counts.fill_(-1)
            try:
                tw._launch_walk(codes, *t, unit_k, plan, buf, counts)
            except RuntimeError:  # refused: its tiles pass shared memory
                continue
            print(json.dumps({
                "kernel": name, "band": W, "pairs": B, "chosen": k == 0,
                **plan, "same_counts": bool(torch.equal(counts, first)),
                "ms_median_min_max": _time_ms(lambda: tw._launch_walk(
                    codes, *t, unit_k, plan, buf, counts), 9),
            }), flush=True)
        del buf
    return 0


if __name__ == "__main__":
    sys.exit(main())
