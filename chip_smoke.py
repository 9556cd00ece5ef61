#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main paths through the entry points a user calls, after
building every CUDA kernel from the sources in this checkout and holding
each against its plain PyTorch version on the card:

* `distance`: `levenshtein_k_batch` on 196,608 pairs of 1000 bytes at
  k = 32, unit costs (kernel `myers_distance`);
* `search`: `levenshtein_search_simd_with_opts` with a 24-byte needle at
  k = 3 over a 128 MiB haystack, unit costs and the restricted-Damerau
  preset (kernel `myers_search`);
* `band_distance`: the same 196,608 pairs with adjacent swaps added, at
  k = 32 under the restricted-Damerau costs, then 4,096 pairs of 20,000
  bytes at k = 256 under affine costs (2, 1, 2): the general band kernel in
  its short and its long regime;
* `band_trace`: `levenshtein_k_batch(..., trace_on=True)` on 8,192 pairs of
  1000 bytes at k = 32 and on 256 pairs of 3000 bytes at k = 64: the traced
  band kernel, the batched walk on the device and the RLE decode;
* `hamming`: `hamming_batch` on the distance pairs and a Hamming search of
  the search needle over the 128 MiB haystack (plain PyTorch ops: the JAX
  package has no hand-written kernel there either).

Every phase prints one JSON line and any failure ends the run with a
non-zero exit code; nothing is caught and carried past.  Needs one CUDA
device and `nvcc`; without a device it exits non-zero before printing any
result.

Environment: CHIP_SMOKE_PAIRS / CHIP_SMOKE_HAY_MB cut the sizes (every
batch shrinks by the same share; the cut is printed on its own line).
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

FULL_PAIRS = 196_608
FULL_HAY_MB = 128
STR_LEN = 1000
K_DIST = 32
NEEDLE_LEN = 24
K_SEARCH = 3
N_PLANTED = 64
# haystack sizes of the kernel checks: short needles, long needles; both
# odd, so the last segment is shorter than the others
CHECK_HAY_BYTES = ((3 << 20) + 1234, (1 << 20) + 777)
CHECK_PAIRS = 2048

# Peak rates of one H100 SXM (NVIDIA's data sheet): 3.35 TB/s of HBM, and
# 67 TFLOP/s of float32 outside the tensor cores = 128 lanes x 2 (FMA) per
# SM and clock; an SM has half as many 32-bit integer lanes and an integer
# instruction counts once, so 67 / 4 = 16.75 T 32-bit integer operations a
# second.
PEAK_BYTES_PER_S = 3.35e12
PEAK_INT32_OPS_PER_S = 67e12 / 4

# 32-bit integer operations the two functions need, counted as the card
# would issue them at its best: one instruction for any logic function of
# three inputs, one for a funnel shift across two registers, an add with
# carry in one instruction, and the narrowest 32-bit word count that holds
# the band (K1) or the needle (K2).  None of the kernel's own overhead
# (ring upkeep, rotates, byte extraction, 64-bit words) is in here.
#
# K1, per row and 32 band bits, 12: the two shifts-right with fill (2),
# x = Eq & Ph and the add with carry (2), X = (sum ^ Ph) | Eq (1),
# Xh = Eq | Mh (1), Pv and Mv (2), their shifts-left with fill (2), Ph and
# Mh (2).  Per row besides: the anchor update (two bit picks and a 3-input
# add) 3 and one for fetching Eq; the virtual-column masks apply to the
# first ukL rows only and are left out.
K1_OPS_PER_ROW_WORD32 = 12
K1_OPS_PER_ROW = 4
# K2, per column and 32 needle bits: the Peq lookup (1), x = Eq & Pv, the
# add, Xh, Ph, Mh (5), the two shifts-left, D0, Pv, Mv (5) = 11; with the
# restricted-Damerau seeds two more shifts and two 3-input logic
# instructions = 15.  Per column besides, 4: the score kept scaled by the
# last row's bit (two bit picks, one 3-input add) and one shift to emit it.
K2_OPS_PER_COL_WORD32 = {False: 11, True: 15}
K2_OPS_PER_COL = 4
# The band kernels, per band cell that lies inside the DP matrix
# (0 <= j <= n), counted for a loop that visits those cells only, with INF
# sentinels beside the band's ends: no validity test, no validity select
# and no INF clamp is in here, they are the kernel's own overhead.  Hopper's
# fused add-min (min(a + b, c), one DPX instruction) counts as one.  7: the
# character compare and the predicated add of the mismatch cost that form
# sub (2); dp1_up + start + gap and min(bgap_up + gap, that) as one fused
# add-min, the vertical gap (2); dprime = min(sub, vertical) (1); the
# running prefix-min of dprime - c*gap as one fused add-min (1); the
# horizontal candidate prefix + c*gap + start folded into the cascade's min
# as one fused add-min (1).  The strings' bytes are counted as fetched for
# free.
BAND_OPS_PER_CELL = 7
# with transposition, 3 more: the two character compares, the second one
# anding its predicate with the first (2), and min(dp0 + cost, cell) as one
# predicated fused add-min (1); the row / column guards are sentinels
BAND_OPS_TRANSPOSE = 3
# with the argmin code, 6 more: the compares of the cascade that a plain
# min does not need (2, a third with transposition), two selects that form
# the code, shift and or into the packed word (2)
BAND_OPS_CODE = {False: 6, True: 7}

# the band phases (sizes of the full run)
TRACE_PAIRS = 8192
LONG_PAIRS, LONG_LEN, K_LONG = 4096, 20_000, 256
TRACE_LONG_PAIRS, TRACE_LONG_LEN, K_TRACE_LONG = 256, 3000, 64
AFFINE = (2, 1, 2, None)
SWAPS_PER_PAIR = 4
HAMMING_K = 3


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def time_launches(fn, reps: int = 15):
    """(median, least, most) milliseconds of `fn()` on the device over
    `reps` launches (CUDA events, one warm-up first)."""
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
    return statistics.median(times), min(times), max(times)


def time_once_ms(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

def make_pairs(n_pairs: int):
    """The headline distance batch: random printable 1000-byte strings and
    a copy with 8..16 positions overwritten (seed 1234)."""
    rng = np.random.default_rng(1234)

    def mutate(a, k):
        b = a.copy()
        idx = rng.permutation(len(a))[: rng.integers(k // 2, k + 1)]
        b[idx] = 32
        return b

    a_list = [rng.integers(33, 127, STR_LEN).astype(np.uint8)
              for _ in range(n_pairs)]
    b_list = [mutate(a, K_DIST // 2) for a in a_list]
    return a_list, b_list


def make_haystack(n_bytes: int):
    """The headline search input: upper-case noise, a lower-case needle,
    64 planted copies with two positions overwritten (seed 1234)."""
    rng = np.random.default_rng(1234)
    needle = rng.integers(97, 123, NEEDLE_LEN).astype(np.uint8)
    hay = rng.integers(65, 91, n_bytes).astype(np.uint8)
    planted = rng.integers(0, n_bytes - NEEDLE_LEN, N_PLANTED)
    for pos in planted:
        mut = needle.copy()
        mut[rng.integers(0, NEEDLE_LEN, 2)] = 97
        hay[pos: pos + NEEDLE_LEN] = mut
    return needle, hay, np.sort(planted)


def swap_adjacent(rows: np.ndarray, n_swaps: int, rng) -> None:
    """Swap `n_swaps` random adjacent character pairs in every row, in
    place (a swap of two equal characters changes nothing)."""
    n, length = rows.shape
    p = np.arange(n)
    for _ in range(n_swaps):
        q = rng.integers(0, length - 1, n)
        left = rows[p, q].copy()
        rows[p, q] = rows[p, q + 1]
        rows[p, q + 1] = left


def make_edited_pairs(n_pairs: int, length: int, n_sub: int, max_ins: int,
                      seed: int):
    """Pairs for the band phases: a random printable string of `length`
    bytes, and a copy with up to `n_sub` positions overwritten,
    SWAPS_PER_PAIR adjacent swaps and 0..max_ins bytes inserted."""
    rng = np.random.default_rng(seed)
    a = rng.integers(33, 127, (n_pairs, length)).astype(np.uint8)
    b = a.copy()
    rows = np.arange(n_pairs)[:, None]
    b[rows, rng.integers(0, length, (n_pairs, n_sub))] = 32
    swap_adjacent(b, SWAPS_PER_PAIR, rng)
    b_list = []
    for p in range(n_pairs):
        g = int(rng.integers(0, max_ins + 1))
        b_list.append(np.insert(b[p], rng.integers(0, length + 1, g),
                                rng.integers(33, 127, g).astype(np.uint8)))
    return list(a), b_list


def planted_alone(planted: np.ndarray) -> np.ndarray:
    """The planted copies that no other copy overwrote in part (the others
    prove nothing)."""
    gaps = np.diff(planted)
    alone = np.ones(planted.size, dtype=bool)
    alone[:-1] &= gaps >= NEEDLE_LEN
    alone[1:] &= gaps >= NEEDLE_LEN
    checked = planted[alone]
    check(checked.size >= N_PLANTED // 2, "too many planted copies overlap")
    return checked


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version on the card
# ---------------------------------------------------------------------------

def distance_cases(rng, n_pairs: int, max_m: int, k: int):
    a_list, b_list = [], []
    for p in range(n_pairs):
        m = int(rng.integers(0, max_m + 1))
        a = rng.integers(65, 70, m).astype(np.uint8)
        if m and p % 4 == 0:
            a[rng.integers(0, m, 3)] = 0  # NUL bytes: pads are 0 too
        b = a.copy()
        if m:
            b[rng.integers(0, m, int(rng.integers(0, k + 2)))] = 66
        grow = int(rng.integers(0, k + 1)) if p % 3 else k  # max-delta pairs
        b = np.insert(b, rng.integers(0, len(b) + 1, grow),
                      rng.integers(65, 70, grow).astype(np.uint8))
        a_list.append(a)
        b_list.append(b)
    a_list[0] = b_list[0] = np.empty(0, np.uint8)
    return a_list, b_list


def check_distance_kernel(dev):
    from triple_accel_tpu_torch.ops.myers_distance import (
        myers_distance, myers_distance_plain, prepare_myers_inputs)

    rng = np.random.default_rng(2024)
    cases, worst = 0, 0
    for max_m in (64, 1024):
        for k in (4, 32, 63, 64, 159):
            a_list, b_list = distance_cases(rng, CHECK_PAIRS, max_m, k)
            ks = np.maximum(rng.integers(0, k + 1, len(a_list)),
                            [len(b) - len(a) for a, b in zip(a_list, b_list)])
            for per_pair in (None, ks):
                t = prepare_myers_inputs(a_list, b_list, k, max_m,
                                         ks=per_pair, device=dev)
                got = myers_distance(*t, k=k)
                torch.cuda.synchronize()
                ref = myers_distance_plain(*t, k=k)
                err = int((got.to(torch.int64) - ref.to(torch.int64))
                          .abs().max())
                worst = max(worst, err)
                check(err == 0, f"myers_distance != plain at k={k} "
                                f"max_m={max_m} per_pair={per_pair is not None}")
                cases += 1
    return cases, worst


def check_search_kernel(dev):
    from triple_accel_tpu_torch.ops.myers_search import (
        myers_search, myers_search_plain, prepare_myers_needles,
        suggest_own_len)
    from triple_accel_tpu_torch.ops.search_common import window_span

    rng = np.random.default_rng(4048)
    cases, worst = 0, 0
    k = 3
    for m in (1, 24, 64, 65, 700, 1280):
        n = CHECK_HAY_BYTES[0] if m <= 65 else CHECK_HAY_BYTES[1]
        hay = rng.integers(65, 69, n).astype(np.uint8)
        hay[:2] = 0
        needles = [rng.integers(65, 69, m).astype(np.uint8) for _ in range(2)]
        needles[1][0] = 0  # a NUL needle byte against a NUL haystack start
        for pos in rng.integers(0, n - m, 16):
            hay[pos: pos + m] = needles[0]
            if m > 4:
                hay[pos + 1], hay[pos + 2] = hay[pos + 2], hay[pos + 1]
        nd = prepare_myers_needles(needles, m, device=dev)
        for damerau in (False, True):
            for anchored in (False, True):
                if anchored:
                    iter_len, halo = min(m + k, n), 0
                    own_len = iter_len
                else:
                    iter_len = n
                    halo = min(-(-window_span(m, k, 1, 0) // 256) * 256, n)
                    # the tail segment is shorter than own_len (n is odd)
                    own_len = min(suggest_own_len(iter_len, halo), 4096)
                hay_d = torch.from_numpy(hay[:iter_len].copy()).to(dev)
                got = myers_search(hay_d, nd, own_len=own_len, halo=halo,
                                   anchored=anchored, damerau=damerau)
                torch.cuda.synchronize()
                ref = myers_search_plain(hay_d, nd, own_len=own_len,
                                         halo=halo, anchored=anchored,
                                         damerau=damerau)
                err = int((got.to(torch.int64) - ref.to(torch.int64))
                          .abs().max())
                worst = max(worst, err)
                check(err == 0, f"myers_search != plain at m={m} "
                                f"damerau={damerau} anchored={anchored}")
                cases += 1
    return cases, worst


def band_cases(rng, n_pairs: int, max_m: int, unit_k: int):
    """Pairs inside the band over a four-letter alphabet (many ties, many
    transposition candidates): overwritten positions, adjacent swaps,
    deletions and insertions, NUL bytes, every third pair at the band's
    edge (n - m == unit_k), every seventh at the full row count, an empty
    pair and an empty a against a non-empty b."""
    a_list, b_list = [], []
    for p in range(n_pairs):
        m = int(rng.integers(0, max_m + 1)) if p % 7 else max_m
        a = rng.integers(65, 69, m).astype(np.uint8)
        if m and p % 4 == 0:
            a[rng.integers(0, m, 3)] = 0  # NUL bytes: pads are 0 too
        b = a.copy()
        if m:
            b[rng.integers(0, m, int(rng.integers(0, unit_k + 2)))] = 66
        if m > 1:
            for q in rng.integers(0, m - 1, 3).tolist():
                b[q], b[q + 1] = int(b[q + 1]), int(b[q])
        if m:
            b = np.delete(b, rng.integers(
                0, m, int(rng.integers(0, min(unit_k, m) // 2 + 1))))
        grow = unit_k if p % 3 == 0 else int(rng.integers(0, unit_k + 1))
        ins = m + grow - len(b)
        b = np.insert(b, rng.integers(0, len(b) + 1, ins),
                      rng.integers(65, 69, ins).astype(np.uint8))
        a_list.append(a)
        b_list.append(b)
    a_list[0] = b_list[0] = np.empty(0, np.uint8)
    a_list[1] = np.empty(0, np.uint8)  # m == 0 against n > 0
    b_list[1] = b_list[1][:unit_k]
    return a_list, b_list


def costs_tuple(costs):
    return (costs.mismatch_cost, costs.gap_cost, costs.start_gap_cost,
            costs.transpose_cost_or_zero, costs.allow_transpose)


def band_errors(got_d, got_codes, ref_d, ref_codes, t, unit_k: int,
                walk: bool) -> int:
    """Largest disagreement between the kernel's and the plain version's
    distances, argmin codes (rows 1..m of each pair: the kernel writes no
    others) and, with `walk`, the edit streams walked from the codes."""
    from triple_accel_tpu_torch.ops.band_scan import walk_packed_traceback

    err = int((got_d.to(torch.int64) - ref_d.to(torch.int64)).abs().max())
    if got_codes is None:
        return err
    rows = got_codes.shape[1]
    live = (torch.arange(rows, device=got_codes.device)[None, :]
            < t[2][:, None])[:, :, None]
    err = max(err, int(((got_codes != ref_codes) & live).any()))
    if walk:
        seq_g, _ = walk_packed_traceback(got_codes, *t, unit_k=unit_k)
        seq_r, _ = walk_packed_traceback(ref_codes, *t, unit_k=unit_k)
        err = max(err, int((seq_g.to(torch.int32)
                            - seq_r.to(torch.int32)).abs().max()))
    return err


def check_band_kernels(dev):
    """The band kernels over a seeded grid of cost models, band widths and
    lengths: the short regime, the long one (rows >= 16384, band 513) and
    the widest band the plan takes (unit_k 4096, 200 KB of dynamic shared
    memory a block).  Distances, codes and walked edit streams equal the
    plain version's exactly."""
    from triple_accel_tpu_torch.ops.band_scan import band_scan_distance
    from triple_accel_tpu_torch.ops.lev_band import (
        MAX_UNIT_K, band_distance, band_trace, prepare_band_tensors)
    from triple_accel_tpu_torch.types import (
        EditCosts, LEVENSHTEIN_COSTS, RDAMERAU_COSTS)

    rng = np.random.default_rng(777)
    short = [(4, 64, 2048), (32, 1024, 1024), (100, 700, 512),
             (512, 2000, 96)]
    long_ = [(256, 16_400, 16)]
    wide = [(MAX_UNIT_K, 1500, 12)]
    cases = {"short": 0, "long": 0, "wide": 0}
    worst = 0
    for costs in (LEVENSHTEIN_COSTS, RDAMERAU_COSTS, EditCosts(*AFFINE),
                  EditCosts(3, 2, 1, 2)):
        ct = costs_tuple(costs)
        both = costs in (RDAMERAU_COSTS, EditCosts(*AFFINE))
        for regime, grid in (("short", short), ("long", long_ if both else []),
                             ("wide", wide if both else [])):
            for unit_k, max_m, n_pairs in grid:
                a_list, b_list = band_cases(rng, n_pairs, max_m, unit_k)
                t = prepare_band_tensors(a_list, b_list, unit_k, max_m,
                                         device=dev)
                got_d = band_distance(*t, unit_k=unit_k, costs_t=ct)
                got_dt, got_codes = band_trace(*t, unit_k=unit_k, costs_t=ct)
                torch.cuda.synchronize()
                ref_d, ref_codes = band_scan_distance(
                    *t, unit_k=unit_k, costs_t=ct, trace_on=True)
                err = max(
                    band_errors(got_d, None, ref_d, None, t, unit_k, False),
                    band_errors(got_dt, got_codes, ref_d, ref_codes, t,
                                unit_k, walk=regime != "long"))
                worst = max(worst, err)
                check(err == 0, f"band kernels != plain at costs={ct} "
                                f"unit_k={unit_k} max_m={max_m}")
                cases[regime] += 2  # the untraced and the traced kernel
                del got_codes, ref_codes
    return cases, worst


# ---------------------------------------------------------------------------
# phases 4 and 5: the main paths
# ---------------------------------------------------------------------------

def run_distance(dev, a_list, b_list, gen_s: float, native_loaded: bool):
    import triple_accel_tpu_torch as tt
    from triple_accel_tpu_torch.dispatch import (
        dispatch_history, last_dispatch, round_up_pow2)
    from triple_accel_tpu_torch.ops import myers_distance as md
    from triple_accel_tpu_torch.oracle import levenshtein_naive_k
    from triple_accel_tpu_torch.utils.native import (
        myers_distance_batch_native)

    n_pairs = len(a_list)
    dispatch_history(clear=True)
    md.myers_distance.launches = 0  # counts start at 0 just before the path
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = tt.levenshtein_k_batch(a_list, b_list, K_DIST)
    torch.cuda.synchronize()
    e2e_s = time.perf_counter() - t0
    launches = md.myers_distance.launches  # and are read just after it
    check(launches >= 1, "the distance path launched no myers_distance kernel")
    paths = {d.path for _, d in dispatch_history()}
    check(paths == {"myers"} and last_dispatch().path == "myers",
          f"distance dispatch took {paths}")
    check(out.shape == (n_pairs,) and out.dtype == np.int64,
          "distance result has the wrong shape or type")
    check(bool(((out >= 0) & (out <= K_DIST // 2)).all()),
          "a mutated pair came back outside [0, 16]")

    # a reference that is independent of the kernel
    ref_kind = "python oracle only"
    if native_loaded:
        ref = myers_distance_batch_native(a_list, b_list, K_DIST)
        check(ref is not None and np.array_equal(out, ref),
              "levenshtein_k_batch != compiled CPU Myers comparator")
        ref_kind = "ta_myers_distance_batch (all pairs)"
    sample = np.random.default_rng(5).choice(n_pairs, 64, replace=False)
    for p in sample:
        exp = levenshtein_naive_k(a_list[p], b_list[p], K_DIST)
        check(exp is not None and int(out[p]) == exp,
              f"pair {p}: {int(out[p])} != oracle {exp}")

    # kernel only, at the tensors the main path gives it
    t0 = time.perf_counter()
    margs = md.prepare_myers_inputs(
        a_list, b_list, K_DIST, round_up_pow2(STR_LEN, 8),
        ks=np.full(n_pairs, K_DIST), device=dev)
    torch.cuda.synchronize()
    prep_s = time.perf_counter() - t0
    got = md.myers_distance(*margs, k=K_DIST)
    check(np.array_equal(got.cpu().numpy().astype(np.int64), out),
          "kernel-only rerun != main path result")
    ms, ms_min, ms_max = time_launches(
        lambda: md.myers_distance(*margs, k=K_DIST))
    plain = None

    def run_plain():
        nonlocal plain
        plain = md.myers_distance_plain(*margs, k=K_DIST)

    plain_ms = time_once_ms(run_plain)
    err = int((plain.to(torch.int64) - got.to(torch.int64)).abs().max())
    check(err == 0, "myers_distance != plain at the main-path shape")

    m_arr = margs[2].cpu().numpy().astype(np.int64)
    _, wp = md.myers_plan(K_DIST)
    bytes_moved = int((2 * m_arr + wp).sum()) + 16 * n_pairs
    band_words32 = -(-(K_DIST + 1) // 32)
    ops = int(m_arr.sum()) * (
        K1_OPS_PER_ROW_WORD32 * band_words32 + K1_OPS_PER_ROW)
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_INT32_OPS_PER_S * 1e3
    emit({
        "phase": "distance", "pairs": n_pairs, "str_len": STR_LEN,
        "k": K_DIST, "dispatch": "myers", "launches": launches,
        "reference": ref_kind, "oracle_sample": len(sample),
        "datagen_s": round(gen_s, 3), "e2e_s": round(e2e_s, 4),
        "pairs_per_s_e2e": round(n_pairs / e2e_s, 1),
        "host_prep_and_upload_s": round(prep_s, 4),
        "kernel_ms": round(ms, 4),
        "kernel_ms_min_max": [round(ms_min, 4), round(ms_max, 4)],
        "pairs_per_s_kernel": round(n_pairs / (ms * 1e-3), 1),
    })
    return out, {
        "name": "myers_distance", "route": "cuda",
        "source": "triple_accel_tpu_torch/csrc/myers_distance.cu",
        "replaces": "triple_accel_tpu/ops/pallas/lev_myers.py:86",
        "launches": launches, "max_abs_err": err, "ms": ms,
        "ms_min": ms_min, "ms_max": ms_max,
        "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bound_bytes_ms": t_bytes, "bound_operations_ms": t_ops,
        "library_ms": None,
    }


def run_search(dev, needle, hay, planted, gen_s: float, native_loaded: bool):
    from triple_accel_tpu_torch.dispatch import dispatch_history
    from triple_accel_tpu_torch.levenshtein import (
        levenshtein_search_simd_with_opts)
    from triple_accel_tpu_torch.ops import myers_search as ms_mod
    from triple_accel_tpu_torch.ops.search_common import window_span
    from triple_accel_tpu_torch.oracle import (
        levenshtein_search_naive_with_opts)
    from triple_accel_tpu_torch.types import (
        LEVENSHTEIN_COSTS, RDAMERAU_COSTS, SearchType)
    from triple_accel_tpu_torch.utils.native import search_all_native

    n = len(hay)
    dispatch_history(clear=True)
    ms_mod.myers_search.launches = 0  # counts start at 0 just before the path
    results, e2e = {}, {}
    for cname, costs in (("unit", LEVENSHTEIN_COSTS),
                         ("rdamerau", RDAMERAU_COSTS)):
        for st in (SearchType.Best, SearchType.All):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = levenshtein_search_simd_with_opts(
                needle, hay, K_SEARCH, st, costs, False)
            torch.cuda.synchronize()
            e2e[f"{cname}_{st.name}"] = time.perf_counter() - t0
            results[(cname, st)] = res
    launches = ms_mod.myers_search.launches  # and are read just after it
    check(launches == 4, f"4 searches launched {launches} kernels")
    paths = [d.path for _, d in dispatch_history()]
    check(paths == ["myers_search"] * 2 + ["myers_search_rdamerau"] * 2,
          f"search dispatch took {paths}")

    checked = planted_alone(planted)
    for cname in ("unit", "rdamerau"):
        all_m = results[(cname, SearchType.All)]
        by_end = {mt.end: mt for mt in all_m}
        for pos in checked:
            mt = by_end.get(int(pos) + NEEDLE_LEN)
            check(mt is not None and mt.k <= 2,
                  f"{cname}: planted needle at {pos} not found with k <= 2")
        best = results[(cname, SearchType.Best)]
        kmin = min(mt.k for mt in all_m)
        check(best and all(mt.k == kmin for mt in best)
              and all(by_end.get(mt.end) is not None for mt in best),
              f"{cname}: Best-mode matches are not the minimum-cost ones")

    # All-mode matches on a prefix against a reference that never saw the
    # kernel: the compiled scalar search, else the Python oracle (smaller)
    prefix = (1 << 20) if native_loaded else (1 << 16)
    if not native_loaded:
        print(f"cut: search reference prefix {prefix} bytes instead of "
              f"1 MiB (native library not loaded, Python oracle)")
    prefix = min(prefix, n)
    for cname, costs in (("unit", LEVENSHTEIN_COSTS),
                         ("rdamerau", RDAMERAU_COSTS)):
        got = levenshtein_search_simd_with_opts(
            needle, hay[:prefix], K_SEARCH, SearchType.All, costs, False)
        if native_loaded:
            ends, ks, lens = search_all_native(needle, hay[:prefix],
                                               K_SEARCH, costs)
            exp = list(zip((ends - lens).tolist(), ends.tolist(),
                           ks.tolist()))
        else:
            exp = [(mt.start, mt.end, mt.k)
                   for mt in levenshtein_search_naive_with_opts(
                       needle, hay[:prefix], K_SEARCH, SearchType.All,
                       costs, False)]
        check([(mt.start, mt.end, mt.k) for mt in got] == exp,
              f"{cname}: All-mode matches on the prefix != reference")

    # kernel only, at the tensors the main path gives it
    halo = min(-(-window_span(NEEDLE_LEN, K_SEARCH, 1, 0) // 256) * 256, n)
    own_len = ms_mod.suggest_own_len(n, halo)
    hay_d = torch.from_numpy(hay).to(dev)
    nd = ms_mod.prepare_myers_needles([needle], NEEDLE_LEN, device=dev)
    kernel_ms, plain_ms, errs = {}, {}, {}
    for damerau in (False, True):
        kernel_ms[damerau] = time_launches(
            lambda: ms_mod.myers_search(hay_d, nd, own_len=own_len,
                                        halo=halo, damerau=damerau))
        # both cost models against the plain version at this shape
        got = ms_mod.myers_search(hay_d, nd, own_len=own_len, halo=halo,
                                  damerau=damerau)
        plain = None

        def run_plain():
            nonlocal plain
            plain = ms_mod.myers_search_plain(
                hay_d, nd, own_len=own_len, halo=halo, damerau=damerau)

        plain_ms[damerau] = time_once_ms(run_plain)
        errs[damerau] = int((plain - got).abs().max())
        check(errs[damerau] == 0, f"myers_search(damerau={damerau}) != "
                                  f"plain at the main-path shape")
        del plain, got
    err = max(errs.values())

    words32 = -(-NEEDLE_LEN // 32)
    bytes_moved = n + 4 * (n + 1) + NEEDLE_LEN
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = {d: n * (K2_OPS_PER_COL_WORD32[d] * words32 + K2_OPS_PER_COL)
             / PEAK_INT32_OPS_PER_S * 1e3 for d in (False, True)}
    emit({
        "phase": "search", "haystack_bytes": n, "needle_len": NEEDLE_LEN,
        "k": K_SEARCH, "planted": N_PLANTED,
        "planted_found": int(checked.size), "halo": halo,
        "own_len": own_len, "segments": -(-n // own_len),
        "dispatch": ["myers_search", "myers_search_rdamerau"],
        "launches": launches,
        "matches": {f"{c}_{st.name}": len(r)
                    for (c, st), r in results.items()},
        "reference_prefix_bytes": prefix,
        "datagen_s": round(gen_s, 3),
        "e2e_s": {k_: round(v, 4) for k_, v in e2e.items()},
        "GBps_e2e": {k_: round(n / v / 1e9, 3) for k_, v in e2e.items()},
        "kernel_ms_median_min_max": {
            "unit": [round(t, 4) for t in kernel_ms[False]],
            "rdamerau": [round(t, 4) for t in kernel_ms[True]]},
        "GBps_kernel": {
            "unit": round(n / (kernel_ms[False][0] * 1e-3) / 1e9, 2),
            "rdamerau": round(n / (kernel_ms[True][0] * 1e-3) / 1e9, 2)},
    })
    return {
        "name": "myers_search", "route": "cuda",
        "source": "triple_accel_tpu_torch/csrc/myers_search.cu",
        "replaces": "triple_accel_tpu/ops/pallas/search_myers.py:221",
        "launches": launches, "max_abs_err": err,
        "ms": kernel_ms[False][0], "ms_min": kernel_ms[False][1],
        "ms_max": kernel_ms[False][2],
        "plain_ms": plain_ms[False],
        "bound_ms": max(t_bytes, t_ops[False]),
        "bound_by": "bytes" if t_bytes >= t_ops[False] else "operations",
        "bound_bytes_ms": t_bytes, "bound_operations_ms": t_ops[False],
        "library_ms": None,
        # the restricted-Damerau launches of the same path, same shape
        "ms_rdamerau": kernel_ms[True][0],
        "ms_rdamerau_min": kernel_ms[True][1],
        "ms_rdamerau_max": kernel_ms[True][2],
        "plain_ms_rdamerau": plain_ms[True],
        "bound_ms_rdamerau": max(t_bytes, t_ops[True]),
        "bound_operations_ms_rdamerau": t_ops[True],
    }


# ---------------------------------------------------------------------------
# the band phases: general costs, long strings, tracebacks
# ---------------------------------------------------------------------------

def band_valid_cells(m_arr: np.ndarray, n_arr: np.ndarray, unit_k: int) -> int:
    """Band cells of rows 1..m that lie inside the DP matrix, summed over
    the pairs: row i holds columns max(0, i - unit_k) .. min(n, i + unit_k)."""
    pairs, counts = np.unique(np.stack([m_arr, n_arr], axis=1), axis=0,
                              return_counts=True)
    total = 0
    for (m, n), cnt in zip(pairs.tolist(), counts.tolist()):
        i = np.arange(1, m + 1, dtype=np.int64)
        width = np.minimum(n, i + unit_k) - np.maximum(0, i - unit_k) + 1
        total += cnt * int(np.clip(width, 0, None).sum())
    return total


def band_bound(m_arr, n_arr, unit_k: int, ct, traced: bool) -> dict:
    """The least time the card could take for this batch: every string
    byte and length read once, every distance (and packed code word of
    rows 1..m) written once, against the operations of the cells inside
    the matrix."""
    from triple_accel_tpu_torch.ops.band_scan import code_words

    cells = band_valid_cells(m_arr, n_arr, unit_k)
    per_cell = BAND_OPS_PER_CELL
    if ct[4]:
        per_cell += BAND_OPS_TRANSPOSE
    if traced:
        per_cell += BAND_OPS_CODE[bool(ct[4])]
    bytes_moved = int((m_arr + n_arr).sum()) + 12 * m_arr.size
    if traced:
        bytes_moved += int(m_arr.sum()) * code_words(2 * unit_k + 1) * 4
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = cells * per_cell / PEAK_INT32_OPS_PER_S * 1e3
    return {
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bound_bytes_ms": t_bytes, "bound_operations_ms": t_ops,
        "cells": cells, "ops_per_cell": per_cell,
    }


def band_kernel_only(dev, a_list, b_list, decision, costs, traced: bool,
                     out: np.ndarray, reps: int):
    """The band kernel alone at the tensors the main path gave it (batch,
    rows and band of the logged dispatch decision): equal to the main
    path's distances, timed, held against the plain version; traced, the
    walk and the decode are timed too.  Returns the numbers of the
    kernel's entry in the `kernels` line and of the phase line."""
    from triple_accel_tpu_torch.ops import band_scan as bs
    from triple_accel_tpu_torch.ops import lev_band as lb

    ct = costs_tuple(costs)
    unit_k, rows = decision.unit_k, decision.padded_m
    t0 = time.perf_counter()
    t = lb.prepare_band_tensors(a_list, b_list, unit_k, rows, device=dev)
    torch.cuda.synchronize()
    prep_s = time.perf_counter() - t0
    kw = dict(unit_k=unit_k, costs_t=ct)
    extra = {}
    if traced:
        got_d, got_codes = lb.band_trace(*t, **kw)
        times = time_launches(lambda: lb.band_trace(*t, **kw), reps)
    else:
        got_d, got_codes = lb.band_distance(*t, **kw), None
        times = time_launches(lambda: lb.band_distance(*t, **kw), reps)
    check(np.array_equal(got_d.cpu().numpy().astype(np.int64), out),
          "kernel-only rerun != main path result")
    ref = None

    def run_plain():
        nonlocal ref
        ref = bs.band_scan_distance(*t, trace_on=traced, **kw)

    plain_ms = time_once_ms(run_plain)
    err = band_errors(got_d, got_codes, ref[0], ref[1], t, unit_k, False)
    check(err == 0, "band kernel != plain at the main-path shape")
    if traced:
        seq = None

        def run_walk():
            nonlocal seq
            seq, _ = bs.walk_packed_traceback(got_codes, *t, unit_k=unit_k)

        extra["walk_ms"] = round(time_once_ms(run_walk), 2)
        seq_ref, _ = bs.walk_packed_traceback(ref[1], *t, unit_k=unit_k)
        err = max(err, int((seq.to(torch.int32)
                            - seq_ref.to(torch.int32)).abs().max()))
        check(err == 0, "walked edit streams differ at the main-path shape")
        t0 = time.perf_counter()
        bs.decode_walked_batch(seq.cpu().numpy(), [False] * len(a_list))
        extra["fetch_and_decode_s"] = round(time.perf_counter() - t0, 4)
        extra["code_MB"] = round(got_codes.numel() * 4 / 1e6, 1)
    m_arr = t[2].cpu().numpy().astype(np.int64)
    n_arr = t[3].cpu().numpy().astype(np.int64)
    bound = band_bound(m_arr, n_arr, unit_k, ct, traced)
    entry = {
        "max_abs_err": err, "ms": times[0], "ms_min": times[1],
        "ms_max": times[2], "plain_ms": plain_ms, "library_ms": None,
        **{k_: bound[k_] for k_ in ("bound_ms", "bound_by", "bound_bytes_ms",
                                    "bound_operations_ms")},
    }
    phase = {
        "unit_k": unit_k, "band_cells": 2 * unit_k + 1, "rows": rows,
        "threads": lb.band_plan(rows, unit_k, traced)["threads"],
        "host_prep_and_upload_s": round(prep_s, 4),
        "kernel_ms": round(times[0], 4),
        "kernel_ms_min_max": [round(times[1], 4), round(times[2], 4)],
        "plain_ms": round(plain_ms, 1),
        "Gcells_per_s_kernel": round(bound["cells"] / times[0] / 1e6, 2),
        **extra,
    }
    return entry, phase


def band_entry(name: str, regime: str, traced: bool, replaces: str,
               launches: int, numbers: dict) -> dict:
    return {
        "name": name, "route": "cuda",
        "source": "triple_accel_tpu_torch/csrc/band_distance.cu",
        "kernel": f"band_kernel<*, {'true' if traced else 'false'}>",
        "regime": regime,
        "replaces": f"triple_accel_tpu/ops/pallas/lev_band.py:{replaces}",
        "launches": launches, **numbers,
    }


def oracle_sample(a_list, b_list, k: int, costs, out, traces, n_sample: int,
                  what: str) -> int:
    """The Python oracle on a seeded sample: distances and, where traces
    are given, edit lists (same tie-breaks)."""
    from triple_accel_tpu_torch.oracle import levenshtein_naive_k_with_opts

    n_sample = min(n_sample, len(a_list))
    sample = np.random.default_rng(5).choice(len(a_list), n_sample,
                                             replace=False)
    for p in sample.tolist():
        exp = levenshtein_naive_k_with_opts(a_list[p], b_list[p], k,
                                            traces is not None, costs)
        check(exp is not None and int(out[p]) == exp[0],
              f"{what}: pair {p}: {int(out[p])} != oracle {exp}")
        if traces is not None:
            check(traces[p] == exp[1],
                  f"{what}: pair {p}: edits differ from the oracle's")
    return n_sample


def replay_cost(a, b, edits, costs) -> int:
    """Cost of an RLE edit list under `costs` if it turns `a` into `b`
    exactly, else -1.  AGap runs consume b, BGap runs consume a; a gap run
    pays the start cost once.  Equal to the distance for cost models without
    a start cost (the reference keeps one argmin code per cell, so with a
    start cost its traceback may cost more than the distance it belongs
    to)."""
    mc, gc, sgc = costs.mismatch_cost, costs.gap_cost, costs.start_gap_cost
    i = j = cost = 0
    for e in edits:
        c, kind = e.count, e.edit.name
        if kind == "Match":
            if not np.array_equal(a[i:i + c], b[j:j + c]):
                return -1
            i, j = i + c, j + c
        elif kind == "Mismatch":
            if len(a[i:i + c]) != c or len(b[j:j + c]) != c \
                    or (a[i:i + c] == b[j:j + c]).any():
                return -1
            i, j, cost = i + c, j + c, cost + c * mc
        elif kind == "AGap":
            j, cost = j + c, cost + sgc + c * gc
        elif kind == "BGap":
            i, cost = i + c, cost + sgc + c * gc
        else:  # Transpose: c adjacent swaps, two characters each
            x, y = a[i:i + 2 * c], b[j:j + 2 * c]
            if len(x) != 2 * c or len(y) != 2 * c \
                    or not np.array_equal(x[0::2], y[1::2]) \
                    or not np.array_equal(x[1::2], y[0::2]):
                return -1
            i, j = i + 2 * c, j + 2 * c
            cost += c * costs.transpose_cost_or_zero
    return cost if i == len(a) and j == len(b) else -1


def run_band_distance(dev, a_list, b_swapped, k1_pairs, k1_out,
                      native_loaded: bool, scale: float):
    """General-cost distances without traceback, short and long regime."""
    import triple_accel_tpu_torch as tt
    from triple_accel_tpu_torch.dispatch import dispatch_history
    from triple_accel_tpu_torch.ops import lev_band as lb
    from triple_accel_tpu_torch.ops import myers_distance as md
    from triple_accel_tpu_torch.utils.native import (
        scalar_banded_batch_native)

    def drive(a_l, b_l, k, costs, what):
        dispatch_history(clear=True)
        lb.band_distance.launches = 0  # 0 just before the path ...
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = tt.levenshtein_k_batch(a_l, b_l, k, costs)
        torch.cuda.synchronize()
        e2e_s = time.perf_counter() - t0
        launches = lb.band_distance.launches  # ... read just after it
        hist = dispatch_history()
        check(launches >= 1, f"{what}: no band_distance kernel launched")
        check({d.path for _, d in hist} == {"band"},
              f"{what}: dispatch took {[d.path for _, d in hist]}")
        check(out.shape == (len(a_l),) and out.dtype == np.int64,
              f"{what}: result has the wrong shape or type")
        check(bool(((out >= 0) & (out <= k)).all()),
              f"{what}: an edited pair came back outside [0, {k}]")
        return out, e2e_s, launches, hist[-1][1]

    # short regime: the distance phase's pairs, adjacent swaps added
    n_pairs = len(a_list)
    out, e2e_s, launches, dec = drive(a_list, b_swapped, K_DIST,
                                      tt.RDAMERAU_COSTS, "band_distance")
    n_oracle = oracle_sample(a_list, b_swapped, K_DIST, tt.RDAMERAU_COSTS,
                             out, None, 64, "band_distance")
    plain_lev = tt.levenshtein_k_batch(a_list[:4096], b_swapped[:4096],
                                       K_DIST)
    check(bool((out[:4096] <= plain_lev).all())
          and bool((out[:4096] < plain_lev).any()),
          "transpositions never made a pair cheaper than unit costs")
    numbers, phase = band_kernel_only(dev, a_list, b_swapped, dec,
                                      tt.RDAMERAU_COSTS, False, out, 15)
    k3 = band_entry("band_distance", "short", False, "148", launches, numbers)

    # the band kernel forced onto the unit-cost pairs of the distance phase
    md.myers_distance.launches = lb.band_distance.launches = 0
    os.environ["TRIPLE_ACCEL_TORCH_FORCE_PATH"] = "band"
    try:
        forced = tt.levenshtein_k_batch(*k1_pairs, K_DIST)
    finally:
        del os.environ["TRIPLE_ACCEL_TORCH_FORCE_PATH"]
    check(md.myers_distance.launches == 0
          and lb.band_distance.launches >= 1,
          "FORCE_PATH=band did not take the band kernel")
    check(np.array_equal(forced, k1_out),
          "band kernel on unit costs != myers_distance kernel")

    emit({"phase": "band_distance", "regime": "short", "pairs": n_pairs,
          "str_len": STR_LEN, "k": K_DIST, "costs": "RDAMERAU_COSTS",
          "dispatch": dec.path, "launches": launches,
          "oracle_sample": n_oracle, "forced_band_equals_myers": True,
          "e2e_s": round(e2e_s, 4),
          "pairs_per_s_e2e": round(n_pairs / e2e_s, 1),
          "pairs_per_s_kernel": round(n_pairs / (numbers["ms"] * 1e-3), 1),
          **phase})

    # long regime: affine costs, 20,000-byte strings, band 513
    n_long = max(64, int(LONG_PAIRS * scale))
    t0 = time.perf_counter()
    la_list, lb_list = make_edited_pairs(n_long, LONG_LEN, 40, 16, seed=99)
    gen_s = time.perf_counter() - t0
    affine = tt.EditCosts(*AFFINE)
    out, e2e_s, launches, dec = drive(la_list, lb_list, K_LONG, affine,
                                      "band_distance (long)")
    check(dec.unit_k == 256 and dec.padded_m >= 16_384,
          f"long regime ran at unit_k={dec.unit_k} rows={dec.padded_m}")
    if native_loaded:
        ref = scalar_banded_batch_native(la_list[:64], lb_list[:64], K_LONG,
                                         affine)
        check(ref is not None and np.array_equal(out[:64], ref),
              "long regime != compiled scalar banded comparator")
        ref_kind = "ta_scalar_banded_batch (64 pairs)"
    else:
        oracle_sample(la_list, lb_list, K_LONG, affine, out, None, 1,
                      "band_distance (long)")
        ref_kind = "python oracle (1 pair)"
    numbers, phase = band_kernel_only(dev, la_list, lb_list, dec, affine,
                                      False, out, 7)
    k3_long = band_entry("band_distance_long", "long", False, "402",
                         launches, numbers)
    emit({"phase": "band_distance", "regime": "long", "pairs": n_long,
          "str_len": LONG_LEN, "k": K_LONG, "costs": list(AFFINE),
          "dispatch": dec.path, "launches": launches,
          "reference": ref_kind, "datagen_s": round(gen_s, 3),
          "string_MB_on_device": round(
              n_long * (2 * dec.padded_m + 2 * dec.unit_k + 1) / 1e6, 1),
          "e2e_s": round(e2e_s, 4),
          "pairs_per_s_e2e": round(n_long / e2e_s, 1),
          "pairs_per_s_kernel": round(n_long / (numbers["ms"] * 1e-3), 1),
          **phase})
    return k3, k3_long


def run_band_trace(dev, a_list, b_swapped, scale: float):
    """Distances with tracebacks: the traced kernel, the walk, the decode."""
    import triple_accel_tpu_torch as tt
    from triple_accel_tpu_torch.dispatch import dispatch_history
    from triple_accel_tpu_torch.ops import lev_band as lb

    n_short = max(64, int(TRACE_PAIRS * scale))
    n_long = max(32, int(TRACE_LONG_PAIRS * scale))
    ta_list, tb_list = make_edited_pairs(n_long, TRACE_LONG_LEN, 24, 12,
                                         seed=77)
    entries = []
    for (regime, name, replaces, a_l, b_l, k) in (
            ("short", "band_trace", "647", a_list[:n_short],
             b_swapped[:n_short], K_DIST),
            ("long", "band_trace_long", "773", ta_list, tb_list,
             K_TRACE_LONG)):
        dispatch_history(clear=True)
        lb.band_trace.launches = 0  # 0 just before the path ...
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, traces = tt.levenshtein_k_batch(a_l, b_l, k, tt.RDAMERAU_COSTS,
                                             trace_on=True)
        torch.cuda.synchronize()
        e2e_s = time.perf_counter() - t0
        launches = lb.band_trace.launches  # ... read just after it
        hist = dispatch_history()
        check(launches >= 1, f"{name}: no band_trace kernel launched")
        check({d.path for _, d in hist} == {"band_trace"},
              f"{name}: dispatch took {[d.path for _, d in hist]}")
        check(len(traces) == len(a_l) and bool((out >= 0).all()),
              f"{name}: a pair came back without a distance")
        t0 = time.perf_counter()
        for p in range(len(a_l)):
            check(replay_cost(a_l[p], b_l[p], traces[p], tt.RDAMERAU_COSTS)
                  == int(out[p]),
                  f"{name}: pair {p}: the trace does not replay a into b "
                  f"at cost {int(out[p])}")
        replay_s = time.perf_counter() - t0
        n_oracle = oracle_sample(a_l, b_l, k, tt.RDAMERAU_COSTS, out, traces,
                                 32, name)
        numbers, phase = band_kernel_only(dev, a_l, b_l, hist[-1][1],
                                          tt.RDAMERAU_COSTS, True, out, 9)
        entries.append(band_entry(name, regime, True, replaces, launches,
                                  numbers))
        emit({"phase": "band_trace", "regime": regime, "pairs": len(a_l),
              "str_len": len(a_l[0]), "k": k, "costs": "RDAMERAU_COSTS",
              "dispatch": hist[-1][1].path, "launches": launches,
              "traces_replayed": len(a_l), "replay_check_s": round(
                  replay_s, 2),
              "oracle_trace_sample": n_oracle,
              "edit_runs_per_pair": round(
                  sum(len(t_) for t_ in traces) / len(traces), 1),
              "e2e_s": round(e2e_s, 4),
              "pairs_per_s_e2e": round(len(a_l) / e2e_s, 1),
              "pairs_per_s_kernel": round(
                  len(a_l) / (numbers["ms"] * 1e-3), 1),
              **phase})
    return entries


def run_hamming(dev, a_list, b_list, needle, hay, planted):
    """Hamming distance and search: plain PyTorch ops on the card (the JAX
    package has no hand-written kernel here either, so none is counted)."""
    import triple_accel_tpu_torch as tt
    from triple_accel_tpu_torch.dispatch import last_dispatch
    from triple_accel_tpu_torch.hamming import hamming_search_simd_with_opts

    a2, b2 = np.stack(a_list), np.stack(b_list)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = tt.hamming_batch(a2, b2)
    torch.cuda.synchronize()
    batch_s = time.perf_counter() - t0
    check(last_dispatch().path == "torch", "hamming_batch dispatch")
    check(np.array_equal(out, (a2 != b2).sum(axis=1)),
          "hamming_batch != numpy (a != b).sum")

    n, m = len(hay), len(needle)
    res, secs = {}, {}
    for st in (tt.SearchType.All, tt.SearchType.Best):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res[st] = hamming_search_simd_with_opts(needle, hay, HAMMING_K, st)
        torch.cuda.synchronize()
        secs[st.name] = time.perf_counter() - t0
    by_start = {mt.start: mt for mt in res[tt.SearchType.All]}
    checked = planted_alone(planted)
    for pos in checked.tolist():
        mt = by_start.get(pos)
        check(mt is not None and mt.end == pos + m and mt.k <= 2,
              f"hamming_search: planted needle at {pos} not found")
    kmin = min(mt.k for mt in res[tt.SearchType.All])
    check([(mt.start, mt.k) for mt in res[tt.SearchType.Best]]
          == [(mt.start, mt.k) for mt in res[tt.SearchType.All]
              if mt.k == kmin], "hamming_search: Best != the minima of All")
    # every position of a prefix, by numpy
    prefix = min(1 << 20, n)
    counts = np.zeros(prefix - m + 1, np.int32)
    for q in range(m):
        counts += hay[q: q + prefix - m + 1] != needle[q]
    exp = [(int(p), int(counts[p])) for p in np.flatnonzero(
        counts <= HAMMING_K)]
    got = [(mt.start, mt.k) for mt in hamming_search_simd_with_opts(
        needle, hay[:prefix], HAMMING_K, tt.SearchType.All)]
    check(got == exp, "hamming_search on the prefix != numpy")
    emit({"phase": "hamming", "dispatch": "torch (plain ops, no kernel)",
          "batch_pairs": len(a_list), "str_len": a2.shape[1],
          "batch_e2e_s": round(batch_s, 4),
          "pairs_per_s_e2e": round(len(a_list) / batch_s, 1),
          "haystack_bytes": n, "needle_len": m, "k": HAMMING_K,
          "planted_found": int(checked.size),
          "matches": {st.name: len(r) for st, r in res.items()},
          "search_e2e_s": {k_: round(v, 4) for k_, v in secs.items()},
          "GBps_e2e": {k_: round(n / v / 1e9, 3) for k_, v in secs.items()},
          "reference_prefix_bytes": prefix})


def front_door(dev):
    """Parity calls and misuse probes that the port carries."""
    import triple_accel_tpu_torch as tt
    from triple_accel_tpu_torch.levenshtein import (
        levenshtein_search_simd_with_opts, levenshtein_simd_k,
        levenshtein_simd_k_with_opts)
    from triple_accel_tpu_torch.oracle import levenshtein_naive_k_with_opts

    check(tt.levenshtein(b"abc", b"ab") == 1, "levenshtein(abc, ab)")
    check(tt.levenshtein_exp(b"abc", b"abcd") == 1, "levenshtein_exp")
    check(tt.levenshtein_search(b"helllo", b"hello world")
          == [tt.Match(0, 5, 1)], "levenshtein_search(helllo, hello world)")
    check(levenshtein_simd_k(b"abc", b"", 1) is None, "None above threshold")
    out = tt.levenshtein_k_batch([b"kitten", b"", b"abc"],
                                 [b"sitting", b"", b"abcdefghij"], 3)
    check(out.tolist() == [3, 0, -1], f"small batch gave {out.tolist()}")
    check(tt.rdamerau(b"abcd", b"abdc") == 1, "rdamerau(abcd, abdc)")
    check(tt.hamming(b"abcd", b"abcc") == 1, "hamming(abcd, abcc)")
    traced = levenshtein_simd_k_with_opts(b"kitten", b"sitting", 3, True)
    check(traced == levenshtein_naive_k_with_opts(b"kitten", b"sitting", 3,
                                                  True)
          and traced[0] == 3 and traced[1][0] == tt.Edit(
              tt.EditType.Mismatch, 1)
          and sum(e.count for e in traced[1]) == 7,
          f"traced single pair gave {traced}")
    # a traced general-cost batch with swapped (len(a) > len(b)), empty and
    # over-threshold pairs: -1 / None above the threshold, oracle edits below
    a_b = [b"kitten", b"sitting", b"", b"abcdefgh", b"ca", b"a\x00b"]
    b_b = [b"sitting", b"kitten", b"", b"ab", b"abc", b"ab\x00"]
    dists, traces = tt.levenshtein_k_batch(a_b, b_b, 3, tt.RDAMERAU_COSTS,
                                           trace_on=True)
    for p, (x, y) in enumerate(zip(a_b, b_b)):
        exp = levenshtein_naive_k_with_opts(x, y, 3, True, tt.RDAMERAU_COSTS)
        got = None if dists[p] < 0 else (int(dists[p]), traces[p])
        check(got == exp and (exp is not None or traces[p] is None),
              f"traced batch pair {p}: {got} != oracle {exp}")
    check(dists.tolist() == [3, 3, 0, -1, 3, 1],
          f"traced batch gave {dists.tolist()}")
    probes = 0
    for fn, exc in (
        (lambda: tt.EditCosts(0, 1, 0, None), ValueError),
        (lambda: levenshtein_search_simd_with_opts(
            b"ab", b"abc", 1, tt.SearchType.Best, tt.EditCosts(1, 1, 0, 3)),
         ValueError),
        (lambda: tt.levenshtein_k_batch([b"a"], [], 1), ValueError),
        (lambda: tt.hamming(b"abcd", b"abc"), ValueError),
        (lambda: tt.levenshtein_k_batch([b"ab"], [b"ba"], 1, mesh=object()),
         NotImplementedError),
        (lambda: tt.hamming_search_sharded(b"ab", b"abab", 1, None),
         NotImplementedError),
    ):
        try:
            fn()
        except exc:
            probes += 1
        else:
            raise RuntimeError("a misuse probe raised nothing")
    emit({"phase": "front_door", "parity_calls": 9, "misuse_probes": probes})


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs one CUDA device", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)

    from triple_accel_tpu_torch.utils import build
    from triple_accel_tpu_torch.utils.native import native_available

    # 1. env
    nvcc = build.find_nvcc()
    nvcc_tail = ""
    if nvcc:
        nvcc_tail = subprocess.run(
            [nvcc, "--version"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[-1]
    native_loaded = native_available()
    emit({
        "phase": "env", "python": sys.version.split()[0],
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "nvcc": nvcc_tail, "device": torch.cuda.get_device_name(0),
        "nvidia_smi": smi_line(), "native_library_loaded": native_loaded,
    })

    # 2. build
    build.load_kernels(rebuild=True)  # always from the sources at hand
    info = build.build_info()
    ptxas = [ln.strip() for ln in info["compiler_output"].splitlines()
             if "Compiling entry function" in ln or "registers" in ln
             or "spill" in ln]
    emit({"phase": "build", "built": info["built"],
          "seconds": round(info["seconds"], 2), "sources": info["sources"],
          "library": os.path.basename(info["path"]), "ptxas": ptxas})
    check(info["built"], "the kernels were not built from this checkout")

    # 3. kernels against their plain versions, on the card
    t0 = time.perf_counter()
    d_cases, d_err = check_distance_kernel(dev)
    s_cases, s_err = check_search_kernel(dev)
    b_cases, b_err = check_band_kernels(dev)
    emit({"phase": "kernel_checks", "tolerance": "exact (integers)",
          "myers_distance": {"cases": d_cases, "max_abs_err": d_err},
          "myers_search": {"cases": s_cases, "max_abs_err": s_err},
          "band_distance_and_band_trace": {
              "cases_short": b_cases["short"], "cases_long": b_cases["long"],
              "cases_widest_band": b_cases["wide"], "max_abs_err": b_err},
          "seconds": round(time.perf_counter() - t0, 1)})

    n_pairs = int(os.environ.get("CHIP_SMOKE_PAIRS", FULL_PAIRS))
    hay_mb = int(os.environ.get("CHIP_SMOKE_HAY_MB", FULL_HAY_MB))
    scale = n_pairs / FULL_PAIRS
    if n_pairs != FULL_PAIRS:
        print(f"cut: {n_pairs} pairs instead of {FULL_PAIRS}, and the "
              f"band phases' batches by the same share")
    if hay_mb != FULL_HAY_MB:
        print(f"cut: {hay_mb} MiB haystack instead of {FULL_HAY_MB} MiB")

    # 4, 5. the two headline paths
    t0 = time.perf_counter()
    a_list, b_list = make_pairs(n_pairs)
    gen_s = time.perf_counter() - t0
    k1_out, k1 = run_distance(dev, a_list, b_list, gen_s, native_loaded)
    k1.update(cases=d_cases, ok=True)
    t0 = time.perf_counter()
    needle, hay, planted = make_haystack(hay_mb << 20)
    gen_s = time.perf_counter() - t0
    k2 = run_search(dev, needle, hay, planted, gen_s, native_loaded)
    k2.update(cases=s_cases, ok=True)

    # 6, 7. general costs, long strings, tracebacks
    b_rows = np.stack(b_list)
    swap_adjacent(b_rows, SWAPS_PER_PAIR, np.random.default_rng(4321))
    b_swapped = list(b_rows)
    k3, k3_long = run_band_distance(dev, a_list, b_swapped,
                                    (a_list, b_list), k1_out, native_loaded,
                                    scale)
    k4, k4_long = run_band_trace(dev, a_list, b_swapped, scale)
    for entry, regime in ((k3, "short"), (k3_long, "long"), (k4, "short"),
                          (k4_long, "long")):
        entry.update(cases=b_cases[regime] // 2, ok=True)

    # 8. Hamming (plain ops)
    run_hamming(dev, a_list, b_list, needle, hay, planted)

    # 9. front door
    front_door(dev)

    emit({"phase": "done",
          "seconds": round(time.perf_counter() - t_start, 1),
          "peak_device_MB": round(torch.cuda.max_memory_allocated() / 2**20)})
    emit({"kernels": [k1, k2, k3, k3_long, k4, k4_long]})
    print(smi_line(), flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
