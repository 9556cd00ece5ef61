#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's two main paths through the entry points a user calls, at
the headline workloads' own shapes — `levenshtein_k_batch` on 196,608 pairs
of 1000 bytes at k = 32, and `levenshtein_search_simd_with_opts` with a
24-byte needle at k = 3 over a 128 MiB haystack (unit costs, then the
restricted-Damerau preset) — after building both CUDA kernels from the
sources in this checkout and holding each against its plain PyTorch
version on the card.  Every phase prints one JSON line and any failure
ends the run with a non-zero exit code; nothing is caught and carried
past.  Needs one CUDA device and `nvcc`; without a device it exits
non-zero before printing any result.

Environment: CHIP_SMOKE_PAIRS / CHIP_SMOKE_HAY_MB cut the two sizes (the
cut is printed on its own line).
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


# ---------------------------------------------------------------------------
# phases 4 and 5: the main paths
# ---------------------------------------------------------------------------

def run_distance(dev, n_pairs: int, native_loaded: bool):
    import triple_accel_tpu_torch as tt
    from triple_accel_tpu_torch.dispatch import (
        dispatch_history, last_dispatch, round_up_pow2)
    from triple_accel_tpu_torch.ops import myers_distance as md
    from triple_accel_tpu_torch.oracle import levenshtein_naive_k
    from triple_accel_tpu_torch.utils.native import (
        myers_distance_batch_native)

    t0 = time.perf_counter()
    a_list, b_list = make_pairs(n_pairs)
    gen_s = time.perf_counter() - t0

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
    return {
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


def run_search(dev, n: int, native_loaded: bool):
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

    t0 = time.perf_counter()
    needle, hay, planted = make_haystack(n)
    gen_s = time.perf_counter() - t0

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

    # planted copies that another copy overwrote in part prove nothing
    gaps = np.diff(planted)
    alone = np.ones(planted.size, dtype=bool)
    alone[:-1] &= gaps >= NEEDLE_LEN
    alone[1:] &= gaps >= NEEDLE_LEN
    checked = planted[alone]
    check(checked.size >= N_PLANTED // 2, "too many planted copies overlap")
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


def front_door(dev):
    """Parity calls and misuse probes that the port carries."""
    import triple_accel_tpu_torch as tt
    from triple_accel_tpu_torch.levenshtein import (
        levenshtein_search_simd_with_opts, levenshtein_simd_k)

    check(tt.levenshtein(b"abc", b"ab") == 1, "levenshtein(abc, ab)")
    check(tt.levenshtein_exp(b"abc", b"abcd") == 1, "levenshtein_exp")
    check(tt.levenshtein_search(b"helllo", b"hello world")
          == [tt.Match(0, 5, 1)], "levenshtein_search(helllo, hello world)")
    check(levenshtein_simd_k(b"abc", b"", 1) is None, "None above threshold")
    out = tt.levenshtein_k_batch([b"kitten", b"", b"abc"],
                                 [b"sitting", b"", b"abcdefghij"], 3)
    check(out.tolist() == [3, 0, -1], f"small batch gave {out.tolist()}")
    probes = 0
    for fn, exc in (
        (lambda: tt.EditCosts(0, 1, 0, None), ValueError),
        (lambda: levenshtein_search_simd_with_opts(
            b"ab", b"abc", 1, tt.SearchType.Best, tt.EditCosts(1, 1, 0, 3)),
         ValueError),
        (lambda: tt.levenshtein_k_batch([b"a"], [], 1), ValueError),
        (lambda: tt.rdamerau(b"abc", b"acb"), NotImplementedError),
        (lambda: tt.hamming(b"abcd", b"abcc"), NotImplementedError),
    ):
        try:
            fn()
        except exc:
            probes += 1
        else:
            raise RuntimeError("a misuse probe raised nothing")
    emit({"phase": "front_door", "parity_calls": 5, "misuse_probes": probes})


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
    emit({"phase": "kernel_checks", "tolerance": "exact (integers)",
          "myers_distance": {"cases": d_cases, "max_abs_err": d_err},
          "myers_search": {"cases": s_cases, "max_abs_err": s_err},
          "seconds": round(time.perf_counter() - t0, 1)})

    n_pairs = int(os.environ.get("CHIP_SMOKE_PAIRS", FULL_PAIRS))
    hay_mb = int(os.environ.get("CHIP_SMOKE_HAY_MB", FULL_HAY_MB))
    if n_pairs != FULL_PAIRS:
        print(f"cut: {n_pairs} pairs instead of {FULL_PAIRS}")
    if hay_mb != FULL_HAY_MB:
        print(f"cut: {hay_mb} MiB haystack instead of {FULL_HAY_MB} MiB")

    # 4, 5. the main paths
    k1 = run_distance(dev, n_pairs, native_loaded)
    k1.update(cases=d_cases, ok=True)
    k2 = run_search(dev, hay_mb << 20, native_loaded)
    k2.update(cases=s_cases, ok=True)

    # 6. front door
    front_door(dev)

    emit({"phase": "done",
          "seconds": round(time.perf_counter() - t_start, 1),
          "peak_device_MB": round(torch.cuda.max_memory_allocated() / 2**20)})
    emit({"kernels": [k1, k2]})
    print(smi_line(), flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
