"""Differential fuzz on the card: every public path against the oracle.

    python3 -m triple_accel_tpu_torch.benches.gpu_fuzz [--device cuda]
        [--sections 1 2 ...] [--scale 1.0]

The counterpart of `benches/tpu_fuzz.py`, with its sections, sizes and
seed (20260816; section s draws from its own generator, seeded with
(20260816, s), so any subset of sections draws the same inputs).  It
drives the compiled kernels through the entry points a user calls and
holds every result against the scalar oracle (`oracle/`), or, where a
pair or a haystack is too long for it, against the compiled CPU
comparators of `native/libta_native.so` (the oracle's DP in C++); the
mesh sections against the meshless calls.  Sections 10, 11 and 13 of
the TPU script exercised Mosaic variants the port does not have; here
they drive the port's own regimes at their thresholds:

* 10: K1 and K2 at their route caps (threshold 191 / 192; needles of
  352 / 353 chars, 288 / 289 under restricted Damerau), K7 at 512 chars
  and K8 past it;
* 11: K3 / K4 short, at the warp regime's widest band and one past it
  (unit_k 256 / 257: 513 / 545 cells and more), K4's cluster regime,
  K10's batch plan (past `WALK_FEW_PAIRS`) and its few-pairs plan;
* 13: K5 and K6 with one strip and with several, K9 banded and full;
* 16 (the port's own): K4's cluster regime forced onto fewer warps than
  strips of columns (its ring), against the oracle.

Sections 12 and 14 run on `parallel.make_mesh()` (every visible card)
and on a mesh of 4 entries of one card; each must equal its meshless run.
Section 15 (banded flat distance) is held against the oracle, never
against the JAX package, whose banded kernel loses paths along the band's
edge.  Every section reads `dispatch_history()` and fails if an engine it
drives was never reached; the whole run covers every engine of the
ladder (`LADDER`).  One JSON line a section (cases, mismatches, engines
reached, regimes, seconds), then the total; exit code 1 on any mismatch
or engine not reached.  `--device cpu` runs the plain versions (the CPU
tests run a cut of the short-string sections); `--scale` multiplies the
trials and batch sizes (not the lengths).  It measures nothing.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..dispatch import dispatch_history
from ..hamming import (
    hamming_search_sharded,
    hamming_search_simd_with_opts,
    hamming_simd_parallel,
)
from ..levenshtein import (
    PackedHaystack,
    levenshtein_k_batch,
    levenshtein_search_many,
    levenshtein_search_sharded,
    levenshtein_search_simd_with_opts,
    levenshtein_simd_k_with_opts,
)
from ..oracle import (
    hamming_naive,
    hamming_search_naive_with_opts,
    levenshtein_naive_k_with_opts,
    levenshtein_search_naive_with_opts,
)
from ..types import (
    LEVENSHTEIN_COSTS,
    RDAMERAU_COSTS,
    EditCosts,
    Match,
    SearchType,
)
from ..utils.native import (
    myers_distance_batch_native,
    scalar_banded_batch_native,
    search_all_native,
)

SEED = 20260816
U32 = (1 << 32) - 1
AFFINE = EditCosts(2, 1, 2, None)
MAX_REPORTS = 8  # mismatch lines printed a section


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


def native_candidates(needle, hay, k: int, costs: EditCosts,
                      anchored: bool = False):
    """Every end position within k as the oracle's All mode lists it, from
    the compiled C++ DP (`search_all_native`); None without the native
    library."""
    got = search_all_native(needle, hay, k, costs, anchored)
    if got is None:
        return None
    return [Match(start=int(e - ln), end=int(e), k=int(d))
            for e, d, ln in zip(*(x.tolist() for x in got))]


def best_matches(cands, k: int):
    """The oracle's Best rules over its candidate stream: the threshold
    shrinks as matches stream, a match replaces the one before it when it
    starts at or before it, and the matches at the final threshold stay."""
    curr_k, res = k, []
    for m in cands:
        if m.k > curr_k:
            continue
        curr_k = m.k
        if res and m.start <= res[-1].start:
            res[-1] = m
        else:
            res.append(m)
    return [m for m in res if m.k == curr_k]


def native_search(needle, hay, k: int, search_type: SearchType,
                  costs: EditCosts, anchored: bool = False):
    """The oracle's search (`levenshtein_search_naive_with_opts`) with its
    candidate stream from the compiled C++ DP: the reference for needles
    and haystacks too long for the Python oracle.  None without the
    native library."""
    cands = native_candidates(needle, hay, k, costs, anchored)
    if cands is None or search_type == SearchType.All:
        return cands
    return best_matches(cands, k)


class Fuzz:
    """One run's state: the device, the scale, and per section the cases,
    mismatches, engines reached and regimes seen."""

    def __init__(self, device: torch.device, scale: float):
        self.dev, self.scale = device, scale
        self.rng = np.random.default_rng(SEED)  # `start` reseeds a section
        self.cases = self.bad = 0
        self.engines: set = set()
        self.regimes: dict = {}
        self.decisions: list = []  # the last `run`'s dispatch log
        self.candidates: dict = {}  # a section's native search candidates

    def start(self, section: int) -> None:
        self.rng = np.random.default_rng([SEED, section])
        self.cases = self.bad = 0
        self.engines, self.regimes = set(), {}
        self.candidates = {}
        dispatch_history(clear=True)

    def n(self, count: int) -> int:
        return max(1, int(round(count * self.scale)))

    def run(self, fn, *args, **kw):
        """`fn(*args, **kw)`, the engines it logged added to the section's."""
        dispatch_history(clear=True)
        out = fn(*args, **kw)
        self.decisions = [d for _, d in dispatch_history(clear=True)]
        self.engines |= {d.path for d in self.decisions}
        return out

    def check(self, ok: bool, what: str) -> None:
        self.cases += 1
        if not ok:
            self.bad += 1
            if self.bad <= MAX_REPORTS:
                print(f"MISMATCH {what}", flush=True)

    def regime(self, name: str, got, want) -> None:
        """A plan the section meant to reach: recorded, and a mismatch if
        it is not the one wanted."""
        self.regimes[name] = got
        self.check(got == want, f"regime {name}: {got} != {want}")

    # shorthands
    def ints(self, lo: int, hi: int, size) -> np.ndarray:
        return self.rng.integers(lo, hi, size).astype(np.uint8)

    def edited(self, a: np.ndarray, edits: int, lo: int, hi: int):
        """a with `edits` random substitutions, insertions and deletions
        (the TPU script's mutation loop)."""
        b = list(a)
        for _ in range(edits):
            op = self.rng.integers(0, 3)
            if op == 0 and b:
                b[self.rng.integers(0, len(b))] = self.rng.integers(lo, hi)
            elif op == 1:
                b.insert(int(self.rng.integers(0, len(b) + 1)),
                         int(self.rng.integers(lo, hi)))
            elif op == 2 and b:
                del b[self.rng.integers(0, len(b))]
        return np.array(b, np.uint8)

    def substituted(self, a: np.ndarray, share: float, lo: int, hi: int):
        b = a.copy()
        idx = self.rng.permutation(len(a))[:int(len(a) * share)]
        b[idx] = self.rng.integers(lo, hi, len(idx))
        return b

    def distances(self, got, a_l, b_l, k, costs, what: str,
                  oracle: bool = True) -> None:
        """Distances against the oracle, or the native banded DP."""
        if oracle:
            exp = []
            for a, b in zip(a_l, b_l):
                r = levenshtein_naive_k_with_opts(a, b, k, False, costs)
                exp.append(-1 if r is None else r[0])
        else:
            exp = scalar_banded_batch_native(a_l, b_l, k, costs)
            self.check(exp is not None, f"{what}: native library missing")
            if exp is None:
                return
        for i, (g, e) in enumerate(zip(got, exp)):
            self.check(int(g) == int(e), f"{what} i{i}: got {g} exp {e}")

    def search(self, got, needle, hay, k, st, costs, anchored, what: str,
               oracle: bool = True) -> None:
        if oracle:
            exp = levenshtein_search_naive_with_opts(needle, hay, k, st,
                                                     costs, anchored)
        else:  # Best and All of one input share the C++ candidate stream
            key = (needle.tobytes(), hay.tobytes(), k, costs, anchored)
            if key not in self.candidates:
                self.candidates[key] = native_candidates(needle, hay, k,
                                                         costs, anchored)
            exp = self.candidates[key]
            if exp is not None and st == SearchType.Best:
                exp = best_matches(exp, k)
        self.check(got == exp, f"{what}: got {got[:3]} exp "
                               f"{None if exp is None else exp[:3]}")

    def band_regime(self, name: str, traced: bool, want: str,
                    max_n: int) -> None:
        """The band plan of the last `levenshtein_k_batch` call, from its
        logged band and rows."""
        from ..ops.lev_band import band_plan

        d = self.decisions[-1]
        plan = band_plan(d.padded_m, d.unit_k, traced, batch=d.padded_n,
                         max_n=max_n)
        self.regime(name, None if plan is None else plan["regime"], want)


# ---------------------------------------------------------------------------
# sections
# ---------------------------------------------------------------------------

def s1_distance(f: Fuzz) -> None:
    """Batched distances, mixed thresholds and cost models."""
    for trial in range(f.n(6)):
        costs = [LEVENSHTEIN_COSTS, RDAMERAU_COSTS, EditCosts(2, 1, 2, None),
                 EditCosts(3, 2, 1, 2)][trial % 4]
        k = int(f.rng.integers(1, 60))
        a_l, b_l = [], []
        for _ in range(f.n(64)):
            a = f.ints(65, 72, int(f.rng.integers(0, 150)))
            a_l.append(a)
            b_l.append(f.edited(a, int(f.rng.integers(0, 12)), 65, 72))
        got = f.run(levenshtein_k_batch, a_l, b_l, k, costs, device=f.dev)
        f.distances(got, a_l, b_l, k, costs, f"DIST t{trial} k={k} {costs}")


def s2_search(f: Fuzz) -> None:
    """Searches: every cost model family, Best and All, anchored or not."""
    for trial in range(f.n(10)):
        costs = [LEVENSHTEIN_COSTS, RDAMERAU_COSTS,
                 EditCosts(2, 1, 1, None)][trial % 3]
        st = SearchType.All if trial % 2 else SearchType.Best
        anchored = trial % 5 == 4
        m, n = int(f.rng.integers(1, 40)), int(f.rng.integers(0, 800))
        needle, hay = f.ints(65, 70, m), f.ints(65, 70, n)
        if n > m and f.rng.integers(0, 2):
            p = int(f.rng.integers(0, n - m))
            hay[p:p + m] = needle
        k = int(f.rng.integers(0, m + 3))
        got = f.run(levenshtein_search_simd_with_opts, needle, hay, k, st,
                    costs, anchored, device=f.dev)
        f.search(got, needle, hay, k, st, costs, anchored,
                 f"SEARCH t{trial} m={m} n={n} k={k} {st} {costs} "
                 f"anchored={anchored}")


def s3_hamming(f: Fuzz) -> None:
    """Hamming search and distance."""
    for trial in range(f.n(6)):
        m = int(f.rng.integers(1, 30))
        n = int(f.rng.integers(m, 2000))
        needle, hay = f.ints(65, 70, m), f.ints(65, 70, n)
        k = int(f.rng.integers(0, m + 1))
        st = SearchType.All if trial % 2 else SearchType.Best
        got = f.run(hamming_search_simd_with_opts, needle, hay, k, st,
                    device=f.dev)
        exp = hamming_search_naive_with_opts(needle, hay, k, st)
        f.check(got == exp, f"HAM t{trial}: {got[:4]} vs {exp[:4]}")
        a = f.ints(0, 256, 500)
        b = a.copy()
        b[f.rng.integers(0, 500, 9)] ^= 1
        f.check(f.run(hamming_simd_parallel, a, b, device=f.dev)
                == hamming_naive(a, b), f"HAM dist t{trial}")


def s4_dictionary(f: Fuzz) -> None:
    """Dictionary search, needles of mixed lengths."""
    hay = f.ints(65, 70, 600)
    needles = [f.ints(65, 70, int(f.rng.integers(1, 30)))
               for _ in range(f.n(12))]
    many = f.run(levenshtein_search_many, needles, hay, 2, SearchType.Best,
                 device=f.dev)
    for i, nd in enumerate(needles):
        f.search(many[i], nd, hay, 2, SearchType.Best, LEVENSHTEIN_COSTS,
                 False, f"MANY i{i}")


def s5_traceback(f: Fuzz) -> None:
    """Single-pair tracebacks."""
    for trial in range(f.n(8)):
        costs = [LEVENSHTEIN_COSTS, RDAMERAU_COSTS][trial % 2]
        a = f.ints(65, 70, int(f.rng.integers(1, 80)))
        b = f.edited(a, int(f.rng.integers(0, 6)), 65, 70)
        got = f.run(levenshtein_simd_k_with_opts, a, b, 1000, True, costs,
                    device=f.dev)
        exp = levenshtein_naive_k_with_opts(a, b, 1000, True, costs)
        f.check(got == exp, f"TRACE t{trial}: {got} vs {exp}")


def s6_batched_trace_long(f: Fuzz) -> None:
    """Batched tracebacks, a needle of 300 chars, 15,000-byte strings."""
    bd_a, bd_b = [], []
    for _ in range(f.n(48)):
        a = f.ints(65, 70, int(f.rng.integers(0, 120)))
        bd_a.append(a)
        bd_b.append(f.edited(a, int(f.rng.integers(0, 8)), 65, 70))
    for costs in (LEVENSHTEIN_COSTS, RDAMERAU_COSTS):
        dists, traces = f.run(levenshtein_k_batch, bd_a, bd_b, 20, costs,
                              trace_on=True, device=f.dev)
        for i in range(len(bd_a)):
            ref = levenshtein_naive_k_with_opts(bd_a[i], bd_b[i], 20, True,
                                                costs)
            exp = (-1, None) if ref is None else ref
            f.check(int(dists[i]) == exp[0] and traces[i] == exp[1],
                    f"BTRACE i{i}: {dists[i]}/{traces[i]} vs {exp}")
    m = 300  # a needle of 10 words of 32 bits
    needle, hay = f.ints(65, 75, m), f.ints(65, 75, 3000)
    mut = needle.copy()
    mut[f.rng.integers(0, m, 4)] = 65
    hay[1000:1000 + m] = mut
    got = f.run(levenshtein_search_simd_with_opts, needle, hay, 6,
                SearchType.All, device=f.dev)
    f.search(got, needle, hay, 6, SearchType.All, LEVENSHTEIN_COSTS, False,
             "LONGNEEDLE", oracle=False)
    la, lb = [], []
    for _ in range(f.n(8)):
        a = f.ints(65, 91, 15000)
        b = a.copy()
        b[f.rng.permutation(15000)[:10]] = 65
        la.append(a)
        lb.append(b)
    got = f.run(levenshtein_k_batch, la, lb, 32, device=f.dev)
    ref = myers_distance_batch_native(la, lb, 32)
    f.check(ref is not None and np.array_equal(got, ref),
            f"LONGSTR: {list(got)} vs {ref}")


def s7_blocked_and_tiled(f: Fuzz) -> None:
    """A 1,700-char needle, wide-band distances, long-pair tracebacks."""
    m = 1700
    needle, hay = f.ints(65, 75, m), f.ints(65, 75, 6000)
    mut = needle.copy()
    mut[f.rng.integers(0, m, 3)] = 65
    hay[2000:2000 + m] = mut
    for costs in (LEVENSHTEIN_COSTS, RDAMERAU_COSTS):
        got = f.run(levenshtein_search_simd_with_opts, needle, hay, 5,
                    SearchType.All, costs, False, device=f.dev)
        f.search(got, needle, hay, 5, SearchType.All, costs, False,
                 f"BLOCKED SEARCH {costs}", oracle=False)
    wa = [f.ints(65, 69, 6000) for _ in range(f.n(4))]
    wb = [f.ints(65, 69, 6100) for _ in range(len(wa))]
    for costs in (LEVENSHTEIN_COSTS, RDAMERAU_COSTS):
        got = f.run(levenshtein_k_batch, wa, wb, U32, costs, device=f.dev)
        f.distances(got, wa, wb, U32, costs, f"WIDEBAND {costs}",
                    oracle=False)
    ta, tb = [], []
    for _ in range(f.n(6)):
        a = f.ints(65, 70, 5000)
        ta.append(a)
        tb.append(f.edited(a, int(f.rng.integers(1, 8)), 65, 70))
    for costs in (LEVENSHTEIN_COSTS, RDAMERAU_COSTS):
        dists, traces = f.run(levenshtein_k_batch, ta, tb, 30, costs,
                              trace_on=True, device=f.dev)
        for i in range(min(2, len(ta))):  # the oracle's trace is slow here
            ref = levenshtein_naive_k_with_opts(ta[i], tb[i], 30, True, costs)
            f.check(int(dists[i]) == ref[0] and traces[i] == ref[1],
                    f"TILEDTRACE {costs} i{i}: {dists[i]} vs {ref[0]}")


def s8_flat_search(f: Fuzz) -> None:
    """A 1,400-char needle under general costs (K8)."""
    m = 1400
    needle, hay = f.ints(65, 75, m), f.ints(65, 75, 5000)
    mut = needle.copy()
    mut[f.rng.integers(0, m, 2)] = 65
    hay[1500:1500 + m] = mut
    for costs in (EditCosts(2, 1, 1, None), EditCosts(1, 1, 0, 1)):
        got = f.run(levenshtein_search_simd_with_opts, needle, hay, 6,
                    SearchType.All, costs, False, device=f.dev)
        f.search(got, needle, hay, 6, SearchType.All, costs, False,
                 f"FLAT {costs}", oracle=False)


def s9_anchored(f: Fuzz) -> None:
    """Anchored searches on K2 and K6, k >= m included (the end-0
    candidate)."""
    for m, k, n, costs in [(24, 30, 400, LEVENSHTEIN_COSTS),
                           (24, 10, 400, RDAMERAU_COSTS),
                           (1500, 400, 3000, LEVENSHTEIN_COSTS),
                           (2000, 2100, 4200, LEVENSHTEIN_COSTS)]:
        needle, hay = f.ints(65, 70, m), f.ints(65, 70, n)
        hay[:m] = needle
        hay[f.rng.integers(0, m, 3)] = 65
        for st in (SearchType.All, SearchType.Best):
            got = f.run(levenshtein_search_simd_with_opts, needle, hay, k,
                        st, costs, True, device=f.dev)
            f.search(got, needle, hay, k, st, costs, True,
                     f"ANCHORED m={m} k={k} {st}", oracle=m < 100)


def _planted(f: Fuzz, m: int, n: int, subs: int, lo: int = 65,
             hi: int = 70):
    """A needle and a haystack holding copies of it with `subs`
    substitutions each, at a tenth and at half of the haystack where a
    copy fits."""
    needle, hay = f.ints(lo, hi, m), f.ints(lo, hi, n)
    for p in (n // 10, n // 2):
        if p + m > n:
            continue
        copy = needle.copy()
        copy[f.rng.integers(0, m, subs)] = lo
        hay[p:p + m] = copy
    return needle, hay


def s10_route_caps(f: Fuzz) -> None:
    """K1 and K2 at their route caps, K7 at 512 chars and K8 past it."""
    from ..ops.myers_search import ROUTE_MAX_NEEDLE
    from ..ops.search_diag import K7_MAX_NEEDLE

    a_l, b_l = [], []
    for _ in range(f.n(32)):
        a = f.ints(65, 75, 400)
        a_l.append(a)
        b_l.append(f.edited(a, int(f.rng.integers(150, 260)), 65, 75))
    for k, engine in ((191, "myers"), (192, "band")):
        got = f.run(levenshtein_k_batch, a_l, b_l, k, device=f.dev)
        f.regime(f"k{k}", f.decisions[-1].path, engine)
        ref = myers_distance_batch_native(a_l, b_l, k)
        f.check(ref is not None and np.array_equal(got, ref),
                f"K1 CAP k={k}: {list(got[:6])} vs "
                f"{None if ref is None else list(ref[:6])}")
    for costs, damerau in ((LEVENSHTEIN_COSTS, False),
                           (RDAMERAU_COSTS, True)):
        cap = ROUTE_MAX_NEEDLE[damerau]
        for m in (cap, cap + 1):
            needle, hay = _planted(f, m, 4000, m // 20)
            for st in (SearchType.All, SearchType.Best):
                got = f.run(levenshtein_search_simd_with_opts, needle, hay,
                            m // 10, st, costs, device=f.dev)
                f.search(got, needle, hay, m // 10, st, costs, False,
                         f"K2 CAP m={m} {st} {costs}", oracle=False)
            f.regime(f"needle{m}_{'rdamerau' if damerau else 'unit'}",
                     f.decisions[-1].path,
                     "myers_search_blocked" if m > cap else
                     ("myers_search_rdamerau" if damerau else "myers_search"))
    for m in (K7_MAX_NEEDLE, K7_MAX_NEEDLE + 1):
        needle, hay = _planted(f, m, 3000, 4)
        for st in (SearchType.All, SearchType.Best):
            got = f.run(levenshtein_search_simd_with_opts, needle, hay, 10,
                        st, AFFINE, device=f.dev)
            f.search(got, needle, hay, 10, st, AFFINE, False,
                     f"K7/K8 CAP m={m} {st}", oracle=False)
        f.regime(f"general_needle{m}", f.decisions[-1].path,
                 "search_diag" if m <= K7_MAX_NEEDLE else "flat_search")


def s11_band_regimes(f: Fuzz) -> None:
    """K3 / K4 short, at the warp regime's widest band and one past it,
    K4's cluster regime, K10's batch and few-pairs plans."""
    from ..ops.trace_walk import WALK_FEW_PAIRS, walk_plan

    def pairs(count, length, edits, lo=65, hi=70):
        a_l, b_l = [], []
        for _ in range(count):
            a = f.ints(lo, hi, length)
            a_l.append(a)
            b_l.append(f.edited(a, edits, lo, hi))
        return a_l, b_l

    # untraced (K3) under affine costs: unit_k = k - 2; the batch's band
    # is unit_k rounded up to a power of two
    a_l, b_l = pairs(f.n(48), 300, 12)
    got = f.run(levenshtein_k_batch, a_l, b_l, 34, AFFINE, device=f.dev)
    f.band_regime("K3_short", False, "warp", 320)
    f.distances(got, a_l, b_l, 34, AFFINE, "K3 short", oracle=False)
    a_l, b_l = pairs(f.n(16), 700, 40)
    for uk, want in ((256, "warp"), (257, "wide")):
        got = f.run(levenshtein_k_batch, a_l, b_l, uk + 2, AFFINE,
                    device=f.dev)
        f.band_regime(f"K3_unit_k{uk}", False, want, 760)
        f.distances(got, a_l, b_l, uk + 2, AFFINE, f"K3 unit_k={uk}",
                    oracle=False)
    # traced (K4, K10) under rDamerau: unit_k = k, rounded up to 16
    a_l, b_l = pairs(f.n(8), 600, 30)
    for uk, want in ((256, "warp"), (257, "wide")):
        dists, traces = f.run(levenshtein_k_batch, a_l, b_l, uk,
                              RDAMERAU_COSTS, trace_on=True, device=f.dev)
        f.band_regime(f"K4_unit_k{uk}", True, want, 660)
        f.distances(dists, a_l, b_l, uk, RDAMERAU_COSTS, f"K4 unit_k={uk}",
                    oracle=False)
        for i in range(len(a_l)):
            f.check(replay_cost(a_l[i], b_l[i], traces[i], RDAMERAU_COSTS)
                    == int(dists[i]), f"K4 unit_k={uk} replay i{i}")
        for i in range(min(2, len(a_l))):
            ref = levenshtein_naive_k_with_opts(a_l[i], b_l[i], uk, True,
                                                RDAMERAU_COSTS)
            f.check(traces[i] == ref[1], f"K4 unit_k={uk} trace i{i}")
    # the cluster regime: long pairs at an unbounded threshold
    a_l, b_l = [], []
    for _ in range(f.n(4)):
        a = f.ints(65, 69, 5000)
        b = f.substituted(a, 0.1, 65, 69)
        b = np.insert(b, f.rng.integers(0, len(b), 100), 65)
        a_l.append(a)
        b_l.append(b)
    dists, traces = f.run(levenshtein_k_batch, a_l, b_l, U32, RDAMERAU_COSTS,
                          trace_on=True, device=f.dev)
    f.band_regime("K4_cluster", True, "wide_cluster",
                  max(len(b) for b in b_l))
    f.distances(dists, a_l, b_l, U32, RDAMERAU_COSTS, "K4 cluster",
                oracle=False)
    for i in range(len(a_l)):
        f.check(replay_cost(a_l[i], b_l[i], traces[i], RDAMERAU_COSTS)
                == int(dists[i]), f"K4 cluster replay i{i}")
    # K10's plans: past WALK_FEW_PAIRS pairs, and within it
    for count in (WALK_FEW_PAIRS + 76, 48):
        a_l, b_l = pairs(f.n(count) if count < WALK_FEW_PAIRS else count,
                         40, 4)
        dists, traces = f.run(levenshtein_k_batch, a_l, b_l, 8,
                              RDAMERAU_COSTS, trace_on=True, device=f.dev)
        d = f.decisions[-1]
        lanes = walk_plan(2 * d.unit_k + 1, len(a_l))["lanes"]
        f.regime(f"K10_{len(a_l)}_pairs_lanes", lanes,
                 4 if len(a_l) > WALK_FEW_PAIRS else 32)
        f.distances(dists, a_l, b_l, 8, RDAMERAU_COSTS,
                    f"K10 {len(a_l)} pairs", oracle=False)
        for i in range(0, len(a_l), max(1, len(a_l) // 32)):
            ref = levenshtein_naive_k_with_opts(a_l[i], b_l[i], 8, True,
                                                RDAMERAU_COSTS)
            f.check(traces[i] == (None if ref is None else ref[1]),
                    f"K10 {len(a_l)} pairs trace i{i}")


def _meshes(f: Fuzz) -> dict:
    from ..parallel import make_mesh

    if f.dev.type == "cpu":
        return {"cpu_1": make_mesh(["cpu"]), "cpu_4": make_mesh(["cpu"] * 4)}
    return {f"cards_{torch.cuda.device_count()}": make_mesh(),
            "shards_4_on_one_card": make_mesh([f.dev] * 4)}


def s12_mesh(f: Fuzz) -> None:
    """The mesh routes of distance, search (unit and general costs) and
    Hamming search."""
    ma, mb = [], []
    for _ in range(f.n(64)):
        a = f.ints(65, 72, int(f.rng.integers(1, 200)))
        b = a.copy()
        b[f.rng.integers(0, len(a), min(4, len(a)))] = 65
        ma.append(a)
        mb.append(b)
    plain = f.run(levenshtein_k_batch, ma, mb, 16, device=f.dev)
    m2 = 20
    needle2, hay2 = f.ints(65, 70, m2), f.ints(65, 70, 3000)
    hay2[700:700 + m2] = needle2
    exp_s = {(st, c): f.run(levenshtein_search_simd_with_opts, needle2,
                            hay2, 3, st, c, device=f.dev)
             for st in (SearchType.All, SearchType.Best)
             for c in (LEVENSHTEIN_COSTS, AFFINE)}
    exp_h = f.run(hamming_search_simd_with_opts, needle2, hay2, 3,
                  SearchType.All, device=f.dev)
    for name, mesh in _meshes(f).items():
        got = f.run(levenshtein_k_batch, ma, mb, 16, mesh=mesh)
        f.check(np.array_equal(got, plain), f"MESH DIST {name}")
        for (st, c), exp in exp_s.items():
            got_s = f.run(levenshtein_search_sharded, needle2, hay2, 3, mesh,
                          st, c)
            f.check(got_s == exp, f"MESH SEARCH {name} {st} {c}: "
                                  f"{got_s[:3]} vs {exp[:3]}")
        got_h = f.run(hamming_search_sharded, needle2, hay2, 3, mesh,
                      SearchType.All)
        f.check(got_h == exp_h, f"MESH HAMMING {name}")


def s13_strips(f: Fuzz) -> None:
    """K5 and K6 with one strip and with several, K9 banded and full."""
    from ..ops.myers_chunked import blocked_plan

    long_m = 21_000  # past one strip: 32 lanes x 20 words of 32 bits
    for m in (6000, long_m):
        f.regime(f"K5_strips_{m}", blocked_plan(m, 5)["strips"] > 1,
                 m == long_m)
    a_l = [f.ints(65, 69, long_m) for _ in range(2)]
    b_l = [f.substituted(a, 0.05, 65, 69) for a in a_l]
    got = f.run(levenshtein_k_batch, a_l, b_l, U32, device=f.dev)
    ref = myers_distance_batch_native(a_l, b_l, U32)
    f.check(ref is not None and np.array_equal(got, ref),
            f"K5 strips unit: {list(got)} vs {ref}")
    got = f.run(levenshtein_k_batch, a_l[:1], b_l[:1], U32, RDAMERAU_COSTS,
                device=f.dev)
    f.distances(got, a_l[:1], b_l[:1], U32, RDAMERAU_COSTS,
                "K5 strips rdamerau", oracle=False)
    needle, hay = _planted(f, long_m, 30_000, 20, 65, 69)
    f.regime("K6_strips", blocked_plan(long_m, 5, search=True,
                                       segments=1)["strips"] > 1, True)
    for st in (SearchType.All, SearchType.Best):
        got = f.run(levenshtein_search_simd_with_opts, needle, hay, 100, st,
                    device=f.dev)
        f.search(got, needle, hay, 100, st, LEVENSHTEIN_COSTS, False,
                 f"K6 strips {st}", oracle=False)
    # K9 through the entry point: past the band plan (unit_k > 4096),
    # banded where the power-of-two band is narrower than the strings
    for length, k, banded in ((12_000, 4600, True), (6000, U32, False)):
        a_l = [f.ints(65, 69, length) for _ in range(2)]
        b_l = [f.substituted(a, 0.1, 65, 69) for a in a_l]
        got = f.run(levenshtein_k_batch, a_l, b_l, k, AFFINE, device=f.dev)
        d = f.decisions[-1]
        f.regime(f"K9_{length}_banded", d.unit_k < length, banded)
        f.distances(got, a_l, b_l, k, AFFINE, f"K9 {length}", oracle=False)


def s14_mesh_engines(f: Fuzz) -> None:
    """Every engine family behind the mesh: the band kernel, K9, K6 and
    the dictionary over one resident haystack, each equal to its
    meshless run."""
    ma, mb = [], []
    for _ in range(f.n(64)):
        a = f.ints(65, 72, int(f.rng.integers(1, 200)))
        b = a.copy()
        b[f.rng.integers(0, len(a), min(4, len(a)))] = 65
        ma.append(a)
        mb.append(b)
    band = f.run(levenshtein_k_batch, ma, mb, 16, AFFINE, device=f.dev)
    fa = [f.ints(65, 70, 5000) for _ in range(f.n(64))]
    fb = [f.substituted(x, 0.02, 65, 70) for x in fa]
    flat = f.run(levenshtein_k_batch, fa, fb, U32, AFFINE, device=f.dev)
    f.distances(flat[:2], fa[:2], fb[:2], U32, AFFINE, "MESH FLAT oracle",
                oracle=False)
    m = 1700
    needle, hay = f.ints(65, 75, m), f.ints(65, 75, 6000)
    mut = needle.copy()
    mut[f.rng.integers(0, m, 3)] = 65
    hay[2000:2000 + m] = mut
    blocked = f.run(levenshtein_search_simd_with_opts, needle, hay, 5,
                    SearchType.All, device=f.dev)
    dict_needles = [f.ints(65, 70, 12) for _ in range(3)]
    dhay = f.ints(65, 70, 4096)
    dhay[500:512] = dict_needles[0]
    dict_plain = f.run(levenshtein_search_many, dict_needles, dhay, 2,
                       SearchType.All, device=f.dev)
    for name, mesh in _meshes(f).items():
        got = f.run(levenshtein_k_batch, ma, mb, 16, AFFINE, mesh=mesh)
        f.check(np.array_equal(got, band), f"MESH BAND {name}")
        got = f.run(levenshtein_k_batch, fa, fb, U32, AFFINE, mesh=mesh)
        f.check(np.array_equal(got, flat), f"MESH FLAT {name}")
        got = f.run(levenshtein_search_sharded, needle, hay, 5, mesh,
                    SearchType.All)
        f.check(got == blocked, f"MESH BLOCKED SEARCH {name}")
        packed = PackedHaystack(dhay, device=f.dev)
        for rep in range(2):  # the second call reuses the resident pack
            got = f.run(levenshtein_search_many, dict_needles, packed, 2,
                        SearchType.All, mesh=mesh)
            f.check(got == dict_plain, f"MESH DICT {name} call {rep}")


def s15_banded_flat(f: Fuzz) -> None:
    """K9 banded (unit_k 2,048) against K9 over the full matrix and the
    oracle, on 20,000-byte pairs."""
    from ..levenshtein import _costs_tuple
    from ..ops.search_flat import flat_distance, prepare_flat_distance_inputs

    ga = [f.ints(65, 70, 20000) for _ in range(f.n(128))]
    gb = []
    for x in ga:
        y = x.copy()
        y[f.rng.integers(0, 20000, 30)] = 71
        gb.append(y)
    fargs = prepare_flat_distance_inputs(ga, gb, device=f.dev)
    ct = _costs_tuple(AFFINE)
    d_band = flat_distance(*fargs, costs_t=ct, unit_k=2048).cpu().numpy()
    d_full = flat_distance(*fargs, costs_t=ct).cpu().numpy()
    f.check(np.array_equal(d_band, d_full),
            f"BANDED FLAT vs full: {np.nonzero(d_band != d_full)[0][:5]}")
    f.distances(d_band[:2], ga[:2], gb[:2], 4000, AFFINE, "BANDED FLAT",
                oracle=False)


def s16_ring(f: Fuzz) -> None:
    """K4's cluster regime forced onto fewer warps than strips (1 to 3
    warps, 3 to 5 strips of 512 columns: the wrap taken, strips whose rows
    do not meet), on random pairs at small bands, with the strips over the
    band's every column in turns (`full_band`); distances and the walked
    traces (K10, then the decode) against the oracle, every trace
    replayed.  The wrappers are called directly (no dispatch)."""
    from ..ops import band_scan as bs
    from ..ops import lev_band as lb
    from ..ops.trace_walk import trace_walk

    maps = ((1, 1), (1, 2), (2, 1), (3, 1))
    models = (LEVENSHTEIN_COSTS, RDAMERAU_COSTS, AFFINE,
              EditCosts(3, 2, 1, 2))
    for trial in range(f.n(8)):
        uk = (8, 16, 40)[trial % 3]
        ctas, warps = maps[trial % 4]
        costs = models[trial % 4]
        ct = (costs.mismatch_cost, costs.gap_cost, costs.start_gap_cost,
              costs.transpose_cost_or_zero, costs.allow_transpose)
        a_l, b_l = [], []
        while len(a_l) < 3:
            a = f.ints(65, 69, int(f.rng.integers(1100, 2100)))
            b = f.edited(a, int(f.rng.integers(0, uk)), 65, 69)
            for q in f.rng.integers(0, len(b) - 1, 4).tolist():
                b[q], b[q + 1] = b[q + 1], b[q]
            a, b = (a, b) if len(a) <= len(b) else (b, a)
            if len(b) - len(a) <= uk:
                a_l.append(a)
                b_l.append(b)
        rows = -(-max(len(a) for a in a_l) // 16) * 16
        t = lb.prepare_band_tensors(a_l, b_l, uk, rows, device=f.dev)
        plan = dict(lb.band_plan(rows, 2 * lb.MAX_UNIT_K, True, max_n=0),
                    ctas_per_pair=ctas, threads=32 * warps,
                    warps_per_pair=ctas * warps,
                    lanes_per_pair=32 * ctas * warps,
                    full_band=trial % 2 == 1)
        dists, codes = lb.band_trace(*t, unit_k=uk, costs_t=ct, plan=plan)
        runs, counts = trace_walk(codes, *t, unit_k=uk)
        traces = bs.decode_walked_batch(runs.cpu().numpy(),
                                        counts.cpu().numpy(),
                                        [False] * len(a_l))
        dists = dists.cpu().numpy()
        kband = uk * costs.gap_cost + costs.start_gap_cost
        what = f"RING t{trial} {ctas}x{warps} uk{uk} full {plan['full_band']}"
        f.regime(f"ring_t{trial}_strips_past_warps",
                 max(-(-(len(b) + 3) // 512) for b in b_l) > ctas * warps,
                 True)
        for i, (a, b) in enumerate(zip(a_l, b_l)):
            ref = levenshtein_naive_k_with_opts(a, b, kband, True, costs)
            if ref is not None:
                f.check(int(dists[i]) == ref[0] and traces[i] == ref[1],
                        f"{what} i{i}: {dists[i]} vs {ref[0]}")
            elif int(dists[i]) < (1 << 30):
                f.check(replay_cost(a, b, traces[i], costs) == int(dists[i]),
                        f"{what} i{i}: replay")


# section -> (name, function, the engines it must reach in the dispatch log)
SECTIONS = {
    1: ("distance", s1_distance, {"myers", "band"}),
    2: ("search", s2_search,
        {"myers_search", "myers_search_rdamerau", "search_diag"}),
    3: ("hamming", s3_hamming, {"torch"}),
    4: ("dictionary", s4_dictionary, {"myers_search_many"}),
    5: ("traceback", s5_traceback, {"band_trace"}),
    6: ("batched_trace_long", s6_batched_trace_long,
        {"band_trace", "myers_search", "myers"}),
    7: ("blocked_and_tiled", s7_blocked_and_tiled,
        {"myers_search_blocked", "myers_blocked_distance", "band_trace"}),
    8: ("flat_search", s8_flat_search, {"flat_search"}),
    9: ("anchored", s9_anchored,
        {"myers_search", "myers_search_rdamerau", "myers_search_blocked"}),
    10: ("route_caps", s10_route_caps,
         {"myers", "band", "myers_search", "myers_search_rdamerau",
          "myers_search_blocked", "search_diag", "flat_search"}),
    11: ("band_regimes", s11_band_regimes,
         {"band", "band_trace", "band_trace_global"}),
    12: ("mesh", s12_mesh,
         {"myers_sharded", "myers_search_sharded", "search_diag_sharded",
          "torch_sharded"}),
    13: ("strips", s13_strips,
         {"myers_blocked_distance", "myers_search_blocked",
          "flat_distance"}),
    14: ("mesh_engines", s14_mesh_engines,
         {"band_sharded", "flat_distance_sharded",
          "myers_search_blocked_sharded", "myers_search_many_sharded"}),
    15: ("banded_flat", s15_banded_flat, set()),
    16: ("ring", s16_ring, set()),
}
LADDER = set().union(*(s[2] for s in SECTIONS.values()))


def run(device, sections=None, scale: float = 1.0) -> dict:
    """Run `sections` (all by default) on `device`; prints one JSON line a
    section and returns the summary: cases, mismatches (an engine a
    section did not reach counts as one), engines reached, the sections'
    lines, seconds."""
    from ..dispatch import resolve_device

    f = Fuzz(resolve_device(device), scale)
    out = {"device": str(f.dev), "scale": scale, "cases": 0,
           "mismatches": 0, "engines_reached": set(), "sections": []}
    t_all = time.perf_counter()
    for s in sections or sorted(SECTIONS):
        name, fn, expects = SECTIONS[s]
        t0 = time.perf_counter()
        f.start(s)
        fn(f)
        for e in sorted(expects - f.engines):
            f.check(False, f"section {s}: engine {e} not reached")
        line = {"section": s, "name": name, "cases": f.cases,
                "mismatches": f.bad, "engines": sorted(f.engines),
                "regimes": f.regimes,
                "seconds": round(time.perf_counter() - t0, 2)}
        print(json.dumps(line), flush=True)
        out["sections"].append(line)
        out["cases"] += f.cases
        out["mismatches"] += f.bad
        out["engines_reached"] |= f.engines
    out["engines_reached"] = sorted(out["engines_reached"])
    out["seconds"] = round(time.perf_counter() - t_all, 2)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--sections", nargs="+", type=int,
                    default=sorted(SECTIONS), choices=sorted(SECTIONS))
    ap.add_argument("--scale", type=float, default=1.0)
    args = ap.parse_args(argv)
    res = run(args.device, args.sections, args.scale)
    print(json.dumps({k: v for k, v in res.items() if k != "sections"}),
          flush=True)
    print(f"FINAL FUZZ TOTAL: {res['mismatches']} mismatches")
    return 1 if res["mismatches"] else 0


if __name__ == "__main__":
    sys.exit(main())
