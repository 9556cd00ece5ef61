#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main paths through the entry points a user calls, after
building every CUDA kernel from the sources in this checkout and holding
each against its plain PyTorch version on the card:

* `distance`: `levenshtein_k_batch` on 196,608 pairs of 1000 bytes at
  k = 32, unit costs (kernel `myers_distance`), and where its end-to-end
  time goes (`e2e_split_s`);
* `search`: `levenshtein_search_simd_with_opts` with a 24-byte needle at
  k = 3 over a 128 MiB haystack, unit costs and the restricted-Damerau
  preset (kernel `myers_search`), and the same split of each call;
* `dictionary`: `levenshtein_search_many` on one `PackedHaystack` of its
  own 128 MiB: 512 short needles at k = 3, unit and restricted-Damerau,
  Best and All, then unit All again (kernel `myers_search`, a length group
  a launch per memory chunk), 4 needles of 400 bytes (`blocked_search`)
  and 4 under affine costs (`search_diag`, a needle at a time);
* `sweep`: `levenshtein_search_sweep` over the search phase's input in 4
  slabs with a checkpoint, Best and All, then a resume after two slabs,
  against the search phase's results;
* `mesh`: every `mesh=` route on `make_mesh()` (every visible card) and
  on 4 shards of one card, over the phases' inputs above (and the later
  `blocked_distance` and `flat_distance` phases' pairs, made once for
  both), each equal to the meshless call and the earlier results:
  `levenshtein_k_batch` on K1, K3 (a cut), K5 and K9,
  `levenshtein_search_sharded` on K2 (with copies of the needle ending
  on and around each shard edge), K6, K7 and K8, the dictionary on one
  `PackedHaystack` twice, `match_count_psum` over a batch on the card,
  Hamming and the sweep, with the seconds of each route's second call
  (the routes in the reverse order of the first calls) beside the
  meshless call's and each kernel's launches a mesh (4 shards of one card
  measure the halo ring's overhead, not scaling;
  `benches/mesh_cards.py` runs the same phase on every card of a
  machine, and `allgather_matches` across a process a card);
* `band_distance`: the same 196,608 pairs with adjacent swaps added, at
  k = 32 under the restricted-Damerau costs, then 4,096 pairs of 20,000
  bytes at k = 256 under affine costs (2, 1, 2): the general band kernel in
  its short and its long regime;
* `band_trace`: `levenshtein_k_batch(..., trace_on=True)` on 8,192 pairs of
  1000 bytes at k = 32 and on 256 pairs of 3000 bytes at k = 64: the traced
  band kernel, the walk kernel `trace_walk` (runs of equal steps) and
  their decode, and where the time goes (`e2e_split_s`); then, past the
  band plan, 128 pairs of
  10,000 ACGT bytes against copies with 10% edits and 1% adjacent swaps at
  an unbounded threshold under the restricted-Damerau costs (unit_k
  10,064, the longest b rounded up to 16: the traced band kernel's
  cluster regime, then the same walk), and one single-pair call of the
  same kind;
* `band_wide`: the band kernels' block regime (bands of 545 - 9,281
  cells) through the entry points: `levenshtein_k_batch` on 4,096 pairs of
  5,000 ACGT bytes with 10% edits at k = 1000 (band 2,049), unit costs,
  then restricted-Damerau with 1% adjacent swaps; the first 512 of them
  traced (band 2,017, then the walk and the decode); 256 pairs of 20,000
  bytes with 5% edits at k = 4000 under affine costs (2, 1, 2) (band
  8,193); `levenshtein()` and `rdamerau()` on one pair of 1,900 bytes
  (band 4,097); then the traced kernel's cluster regime past what a
  cluster held at once, its warps a ring over strips of the columns: (e)
  2 pairs and (f) 64 pairs of 90,000 bytes, 2% edits, k = 5000 (band
  10,017), held against the untraced call (K5) and against the plain
  version on a 2,000-byte prefix;
* `hamming`: `hamming_batch` on the distance pairs and a Hamming search of
  the search needle over the 128 MiB haystack (plain PyTorch ops: the JAX
  package has no hand-written kernel there either);
* `blocked_distance`: `levenshtein_k_batch` at an unbounded threshold (as
  `levenshtein()` / `rdamerau()` call it) on 1,024 pairs of 20,000 ACGT
  bytes against copies with 10% edits, unit costs, then the restricted-
  Damerau costs on the same pairs with adjacent swaps added (kernel
  `blocked_distance`, past the band plan);
* `blocked_search`: `levenshtein_search_simd_with_opts` with a 3,000-byte
  needle at k = 150 over a 128 MiB ACGT haystack holding 16 copies with 1%
  substitutions, unit and restricted-Damerau costs, Best and All, then an
  anchored search at a copy planted at 0 (kernel `blocked_search`);
* `ir` (right after the build): `utils/inspect_ir.py`'s PTX and SASS of
  K1, and the assembler's registers, stack frame and spill bytes of every
  instantiation of every kernel;
* `profile`: the `distance` phase's call once more under
  `utils.profiling.trace`, whose Chrome trace must hold K1's kernel as a
  CUDA event, with the five device operations that took most time;
* `fuzz` (last): `benches/gpu_fuzz.py` at full size, every public path on
  random inputs against the oracle and the compiled CPU comparators, 0
  mismatches and every engine of the ladder reached.

The bounds beside every kernel's time come from `utils/profiling.py`.
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
import re
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from triple_accel_tpu_torch.benches.gpu_fuzz import replay_cost
from triple_accel_tpu_torch.utils import profiling as prof

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

# the band phases (sizes of the full run)
TRACE_PAIRS = 8192
# the traced phase past the band plan: long ACGT pairs with 10% edits and
# 1% adjacent swaps at an unbounded threshold under rDamerau costs (unit_k
# 10,064, a band of 20,129 cells); the plain versions at a cut: K4 over
# the first pairs, the walk over the first pairs of every traced phase
PAST_PLAN_PAIRS, PAST_PLAN_LEN = 128, 10_000
PAST_PLAN_EDIT_SHARE, PAST_PLAN_SWAP_SHARE = 0.10, 0.01
PAST_PLAN_PLAIN_PAIRS, PLAIN_WALK_PAIRS = 2, 64
# the wide-band phase (sizes of the full run): K3 / K4's block regime
# through the entry points a user calls.  (a) ACGT pairs with 10% edits
# at k = 1000 (band 2,049), unit costs, then rDamerau with 1% adjacent
# swaps added; (b) the first of them traced (band 2,017); (c) long pairs
# with 5% edits under affine costs at k = 4000 (band 8,193, the untraced
# regime's widest); (d) one pair through `levenshtein()` / `rdamerau()`
# (band 4,097); (e), (f) K4's cluster regime past what a cluster held at
# once (b of 90,000 bytes: 176 strips of 512 columns on a ring of 21 or
# 24 warps): 2 and 64 traced pairs, held against the untraced call (K5)
# and against the plain version on a prefix of WIDE_DEEP_CUT bytes of
# the first WIDE_PLAIN_PAIRS pairs.  The compiled comparators check the
# first WIDE_NATIVE_PAIRS pairs of every untraced case (unit costs: all
# pairs), on CPU threads beside the card's work.
WIDE_PAIRS, WIDE_LEN, WIDE_EDIT_SHARE, K_WIDE = 4096, 5000, 0.10, 1000
WIDE_SWAP_SHARE, WIDE_TRACE_PAIRS = 0.01, 512
WIDE_AFFINE = (256, 20_000, 0.05, 4000)  # pairs, bytes, edit share, k
WIDE_FRONT = (1900, 0.10)  # bytes, edit share
WIDE_DEEP = (2, 90_000, 0.02, 5000)  # pairs, bytes, edit share, k
WIDE_DEEP_F = (64, 90_000, 0.02, 5000)  # the same that fills the card
WIDE_DEEP_CUT = 2000
WIDE_NATIVE_PAIRS, WIDE_PLAIN_PAIRS = 64, 2
# K10's longest walk alone is timed with L2 warm and with L2 emptied
# before each launch by writing K10_FLUSH_BYTES (L2 is 50 MB)
K10_FLUSH_BYTES = 256 << 20
LONG_PAIRS, LONG_LEN, K_LONG = 4096, 20_000, 256
TRACE_LONG_PAIRS, TRACE_LONG_LEN, K_TRACE_LONG = 256, 3000, 64
AFFINE = (2, 1, 2, None)
SWAPS_PER_PAIR = 4
HAMMING_K = 3

# the blocked phases (sizes of the full run): long pairs at an unbounded
# threshold, a long needle over the search haystack's size
BLOCKED_PAIRS, BLOCKED_LEN, BLOCKED_EDIT_SHARE = 1024, 20_000, 0.10
BLOCKED_SWAP_SHARE = 0.01  # adjacent swaps added for the rDamerau run
LONG_NEEDLE_LEN, K_LONG_NEEDLE = 3000, 150
N_PLANTED_LONG, LONG_NEEDLE_SUBS = 16, 30  # 1% substitutions a copy
# the anchored call: a threshold whose window (m + k = 4000 columns) is one
# the JAX package runs on its chunked engine (myers_chunked.py:386)
K_ANCHORED_LONG = 1000
COPY_FREE_BYTES = 1 << 20  # the haystack's tail holds no planted copy
FRONT_DOOR_LEN, FRONT_DOOR_NEEDLE = 50_000, 2000
ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)
U32_MAX = (1 << 32) - 1
# the general-cost phases (sizes of the full run): the search phase's
# needle and haystack at k = 6 under two of benches/tpu_fuzz.py's general
# cost models; a long needle over a cut of the long-needle haystack; long
# pairs at an unbounded threshold
GENERAL_COSTS = ((2, 1, 2, None), (3, 2, 1, 2))
K_GENERAL = 6
GENERAL_COPY_FREE = 1 << 20
FLAT_HAY_MB, N_PLANTED_FLAT, FLAT_COPY_FREE = 16, 8, 256 << 10
FLAT_DIST_PAIRS, FLAT_DIST_LEN, FLAT_DIST_EDIT_SHARE = 256, 20_000, 0.10
FLAT_DIST_SAMPLE = 8
# the plain versions at a cut: K7 over the haystack's first bytes (the
# plain version pays a step a column of a segment), K8 over two segments,
# K9 over the first pairs cut to their first bytes
DIAG_PLAIN_BYTES, FLAT_PLAIN_SEGMENTS = 1 << 20, 2
FLAT_DIST_PLAIN_PAIRS, FLAT_DIST_PLAIN_LEN = 8, 4000
# the dense-hit route: a periodic needle over a periodic haystack, every
# end position a hit, past the host replay budget
DENSE_NEEDLE, DENSE_HAY, K_DENSE = b"ab" * 200, b"ab" * 600_000, 398
FRONT_DOOR_GENERAL_LEN = 6000
# the dictionary phase (its own haystack, seed DICT_SEED): DICT_PER_LEN
# lower-case needles of each length over upper-case noise, DICT_PLANTED of
# them (an equal share of each length) planted DICT_COPIES times with 1-2
# substitutions, at k = K_DICT; then the K6 group (needles, length, k,
# copies, substitutions a copy) and the general-cost group, searched a
# needle at a time (K7)
DICT_SEED = 5150
DICT_LENS, DICT_PER_LEN, K_DICT = (16, 20, 24, 32), 128, 3
DICT_PLANTED, DICT_COPIES = 64, 4
DICT_LONG = (4, 400, 20, 2, 4)
DICT_GENERAL = (4, 24, 6, 2, 1)
DICT_GENERAL_COSTS = (2, 1, 2, None)
DICT_SLOT = 512  # copies lie in distinct slots of this many bytes
DICT_SAMPLE, DICT_PREFIX_NEEDLES = 16, 8
# the sweep phase: slabs of SWEEP_SLAB bytes (4 over 128 MiB)
SWEEP_SLAB = 1 << 25
# the kernel checks of dictionary launches: a launch of DICT_CHECK_NUM
# needles, and a group whose distances pass torch.nonzero's 2^31 - 1
# elements (needles x (haystack + 1)), cut into launches by the plan and
# held against the plain version DICT_EDGE_PLAIN needles at a time
DICT_CHECK_NUM = 33
DICT_EDGE = (32_769, 65_535, 20)  # needles, haystack bytes, needle chars
DICT_EDGE_PLAIN = 4096


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


def _lower_substitute(seq: np.ndarray, n_subs: int, rng) -> np.ndarray:
    """A copy of a lower-case sequence with `n_subs` positions turned into
    other lower-case letters."""
    out = seq.copy()
    q = rng.choice(len(seq), n_subs, replace=False)
    out[q] = 97 + (out[q] - 97 + rng.integers(1, 26, n_subs)) % 26
    return out


def make_dictionary(n_bytes: int):
    """The dictionary phase's input (seed DICT_SEED; the other phases'
    haystack is untouched): upper-case noise; DICT_PER_LEN lower-case
    needles of each of DICT_LENS; the first DICT_PLANTED // len(DICT_LENS)
    needles of each length planted DICT_COPIES times with 1-2
    substitutions (the first DICT_PREFIX_NEEDLES of them once inside the
    first MiB); the K6 group (DICT_LONG) and the general-cost group
    (DICT_GENERAL) planted with their substitutions.  Every copy lies in
    its own slot of DICT_SLOT bytes.  Returns the haystack, the needle
    lists and each planted needle's copy positions ({group: {needle
    index: [start, ...]}})."""
    rng = np.random.default_rng(DICT_SEED)
    hay = rng.integers(65, 91, n_bytes).astype(np.uint8)
    groups = {
        "short": [rng.integers(97, 123, m).astype(np.uint8)
                  for m in DICT_LENS for _ in range(DICT_PER_LEN)],
        "long": [rng.integers(97, 123, DICT_LONG[1]).astype(np.uint8)
                 for _ in range(DICT_LONG[0])],
        "general": [rng.integers(97, 123, DICT_GENERAL[1]).astype(np.uint8)
                    for _ in range(DICT_GENERAL[0])],
    }
    per_len = DICT_PLANTED // len(DICT_LENS)
    planted_short = [L * DICT_PER_LEN + j for L in range(len(DICT_LENS))
                     for j in range(per_len)]
    copies = [("short", i, 1 + c % 2) for i in planted_short
              for c in range(DICT_COPIES)]
    copies += [("long", i, DICT_LONG[4]) for i in range(DICT_LONG[0])
               for _ in range(DICT_LONG[3])]
    copies += [("general", i, DICT_GENERAL[4]) for i in range(DICT_GENERAL[0])
               for _ in range(DICT_GENERAL[3])]
    prefix_slots = (1 << 20) // DICT_SLOT
    n_slots = n_bytes // DICT_SLOT - 1
    check(n_slots > prefix_slots + len(copies),
          f"a {n_bytes}-byte haystack is too small for the dictionary")
    slots = list(rng.choice(np.arange(prefix_slots, n_slots), len(copies),
                            replace=False))
    # the first DICT_PREFIX_NEEDLES short planted needles: one copy each
    # inside the first MiB
    first = rng.choice(prefix_slots, DICT_PREFIX_NEEDLES, replace=False)
    for j in range(DICT_PREFIX_NEEDLES):
        slots[j * DICT_COPIES] = first[j]
    where = {g: {} for g in groups}
    for (g, i, subs), slot in zip(copies, slots):
        pos = int(slot) * DICT_SLOT + 16
        nd = groups[g][i]
        hay[pos: pos + len(nd)] = _lower_substitute(nd, subs, rng)
        where[g].setdefault(i, []).append(pos)
    return hay, groups, where


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


_ACGT_INDEX = np.zeros(256, dtype=np.uint8)
_ACGT_INDEX[ACGT] = np.arange(4, dtype=np.uint8)


def substitute_acgt(seq: np.ndarray, pos: np.ndarray, rng) -> None:
    """Overwrite the ACGT letters at `pos` with another ACGT letter each,
    in place."""
    seq[pos] = ACGT[(_ACGT_INDEX[seq[pos]]
                     + rng.integers(1, 4, len(pos)).astype(np.uint8)) % 4]


def edit_acgt(a: np.ndarray, n_edits: int, rng) -> np.ndarray:
    """A copy of the ACGT string `a` with `n_edits` edits, each a
    substitution (to another letter), an insertion or a deletion with equal
    odds."""
    kind = rng.integers(0, 3, n_edits)
    n_sub, n_ins = int((kind == 0).sum()), int((kind == 1).sum())
    b = a.copy()
    substitute_acgt(b, rng.choice(len(b), n_sub, replace=False), rng)
    b = np.delete(b, rng.choice(len(b), n_edits - n_sub - n_ins,
                                replace=False))
    return np.insert(b, rng.integers(0, len(b) + 1, n_ins),
                     ACGT[rng.integers(0, 4, n_ins)])


def make_long_pairs(n_pairs: int, length: int, edit_share: float,
                    seed: int):
    """Pairs for the blocked distance phase: a random ACGT string of
    `length` bytes and a copy with `edit_share` of its length in edits
    (`edit_acgt`)."""
    rng = np.random.default_rng(seed)
    a_rows = ACGT[rng.integers(0, 4, (n_pairs, length), dtype=np.uint8)]
    n_edits = int(length * edit_share)
    return list(a_rows), [edit_acgt(a, n_edits, rng) for a in a_rows]


def swap_adjacent_list(rows, share: float, rng):
    """Copies of byte strings of any length with `share` of their length
    in adjacent swaps, made one after the other."""
    out = []
    for r in rows:
        r = r.copy()
        for q in rng.integers(0, max(len(r) - 1, 1),
                              int(len(r) * share)).tolist():
            r[q], r[q + 1] = r[q + 1], r[q]
        out.append(r)
    return out


def make_long_haystack(n_bytes: int, m: int, n_planted: int, n_subs: int,
                       seed: int):
    """The long-needle search input: an ACGT needle of `m` bytes, an ACGT
    haystack of `n_bytes` with `n_planted` copies that carry `n_subs`
    substitutions each, one copy at 0 and one in each equal slot of the
    haystack before its copy-free tail of COPY_FREE_BYTES."""
    rng = np.random.default_rng(seed)
    needle = ACGT[rng.integers(0, 4, m, dtype=np.uint8)]
    hay = ACGT[rng.integers(0, 4, n_bytes, dtype=np.uint8)]
    slot = (n_bytes - COPY_FREE_BYTES) // n_planted
    check(slot >= 2 * m, "the haystack is too short for its copies")
    planted = np.arange(n_planted, dtype=np.int64) * slot
    planted[1:] += rng.integers(0, slot - m, n_planted - 1)
    for pos in planted.tolist():
        copy = needle.copy()
        substitute_acgt(copy, rng.choice(m, n_subs, replace=False), rng)
        hay[pos: pos + m] = copy
    return needle, hay, planted


def merge_intervals(starts: np.ndarray, ends: np.ndarray):
    """Disjoint sorted intervals covering the [starts[i], ends[i])."""
    order = np.argsort(starts, kind="stable")
    out_s, out_e = [], []
    for s0, e0 in zip(starts[order].tolist(), ends[order].tolist()):
        if out_s and s0 <= out_e[-1]:
            out_e[-1] = max(out_e[-1], e0)
        else:
            out_s.append(s0)
            out_e.append(e0)
    return np.array(out_s, np.int64), np.array(out_e, np.int64)


def long_search_intervals(planted: np.ndarray, m: int, k: int, n: int):
    """Where the All-mode reference searches: around every planted copy,
    from one window span (m + k) before it to one after its end, where
    every candidate that overlaps the copy lies with its whole window; and
    the copy-free tail, where there must be none."""
    span = m + k
    starts = np.append(np.maximum(planted - span, 0), n - COPY_FREE_BYTES)
    ends = np.append(np.minimum(planted + m + span, n), n)
    return merge_intervals(starts, ends)


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


# K1's edges: thresholds at the 32-bit word edges of its window (Wp = 64,
# 128, 192 bits: 2, 4, 6 words; k = 31 and 32 share the main path's two
# words), pair lengths at its 16-row chunk edges and 0
DIST_EDGE_KS = (31, 32, 63, 64, 95, 127, 128, 191)
DIST_EDGE_LENS = (0, 1, 15, 16, 17, 31, 32, 33, 63, 64, 65, 100, 255)


def distance_edge_cases(rng, k: int):
    """Pairs on K1's head / body split: for every length of
    DIST_EDGE_LENS, one pair at ukL = 0 (k_pair = delta), one at ukL = 1
    and one at the largest ukL (delta 0, k_pair = k: ukL = k // 2, the
    most virtual-column rows), each b a copy of a with a few
    substitutions and delta inserted bytes.  Returns (a_list, b_list, ks,
    max_m)."""
    a_list, b_list, ks = [], [], []
    for m in DIST_EDGE_LENS:
        for ukl in (0, 1, k // 2):
            delta = 0 if ukl == k // 2 else int(rng.integers(0, k - 2 * ukl + 1))
            kp = delta + 2 * ukl
            a = rng.integers(65, 69, m).astype(np.uint8)
            b = a.copy()
            if m:
                b[rng.integers(0, m, int(rng.integers(0, 4)))] = 68
            b = np.insert(b, rng.integers(0, m + 1, delta),
                          rng.integers(65, 69, delta).astype(np.uint8))
            a_list.append(a)
            b_list.append(b)
            ks.append(kp)
    return a_list, b_list, np.asarray(ks, np.int64), max(DIST_EDGE_LENS)


def check_distance_kernel(dev):
    from triple_accel_tpu_torch.ops.myers_distance import (
        myers_distance, myers_distance_plain, prepare_myers_inputs)

    rng = np.random.default_rng(2024)
    cases, worst = 0, 0

    def run(a_list, b_list, k, max_m, ks, what):
        nonlocal cases, worst
        t = prepare_myers_inputs(a_list, b_list, k, max_m, ks=ks, device=dev)
        got = myers_distance(*t, k=k)
        torch.cuda.synchronize()
        ref = myers_distance_plain(*t, k=k)
        err = int((got.to(torch.int64) - ref.to(torch.int64)).abs().max())
        worst = max(worst, err)
        check(err == 0, f"myers_distance != plain at k={k} max_m={max_m} "
                        f"{what}")
        cases += 1

    for max_m in (64, 1024):
        for k in (4, 32, 63, 64, 159):
            a_list, b_list = distance_cases(rng, CHECK_PAIRS, max_m, k)
            ks = np.maximum(rng.integers(0, k + 1, len(a_list)),
                            [len(b) - len(a) for a, b in zip(a_list, b_list)])
            for per_pair in (None, ks):
                run(a_list, b_list, k, max_m, per_pair,
                    f"per_pair={per_pair is not None}")
    for k in DIST_EDGE_KS:
        a_list, b_list, ks, max_m = distance_edge_cases(rng, k)
        # the edge pairs among a random batch, so their warps mix lengths
        a_r, b_r = distance_cases(rng, 256, max_m, k)
        ks_r = np.maximum(rng.integers(0, k + 1, len(a_r)),
                          [len(b) - len(a) for a, b in zip(a_r, b_r)])
        run(a_list + a_r, b_list + b_r, k, max_m,
            np.concatenate([ks, ks_r]), "edge pairs")
    return cases, worst


# K2's edges, one launch each with two needles: (needle chars, haystack
# bytes, own_len, halo, anchored, damerau, warps a block).  Needles at the
# built word counts' edges (32-bit words 1, 2, 3, 4, 6, 8, 12, 16, 24, 40);
# haystacks one under and one over a multiple of 4, 16 and 32, so the last
# segment is short and ends inside a 16-byte piece; owned lengths that are
# multiples of 32 (the plan's: every segment on a sector), of 16 only, and
# of neither (segments staggered in their first two chunks); halos past
# the first segments' start (they start at byte 0); blocks of 1 to 8 warps
# whose last warp is partly empty; anchored runs (one segment).
SEARCH_EDGE_CASES = (
    (24, 4127, 32, 32, False, False, 8),
    (24, 4129, 64, 32, False, True, 1),
    (5, 3001, 13, 16, False, False, 3),
    (32, 2051, 48, 48, False, True, 2),
    (33, 2047, 100, 80, False, False, 4),
    (64, 1985, 96, 96, False, True, 8),
    (65, 1023, 96, 112, False, False, 5),
    (96, 2017, 160, 128, False, True, 8),
    (97, 999, 128, 144, False, False, 7),
    (160, 1503, 256, 176, False, True, 8),
    (193, 2049, 224, 224, False, False, 2),
    (300, 1601, 320, 336, False, True, 8),
    (400, 1711, 416, 432, False, False, 6),
    (769, 2333, 800, 800, False, True, 8),
    (1280, 2911, 1312, 1312, False, False, 8),
    (24, 27, 27, 0, True, False, 8),
    (65, 68, 68, 0, True, True, 1),
    (1280, 1285, 1285, 0, True, True, 8),
)


def search_edge_input(rng, m: int, n: int):
    """Two needles of m chars over n haystack bytes (alphabet ACGT plus
    NUL): needle 1 holds a NUL byte, the haystack starts with NUL bytes,
    and copies of needle 0 with one adjacent swap lie every 40 + m bytes,
    so copies end in every piece and segment position."""
    needles = np.stack([ACGT[rng.integers(0, 4, m)] for _ in range(2)])
    needles[1, rng.integers(0, m)] = 0
    hay = ACGT[rng.integers(0, 4, n)]
    hay[:2] = 0
    for pos in range(1, n - m, 40 + m):
        hay[pos: pos + m] = needles[0]
        if m > 4:
            q = pos + int(rng.integers(0, m - 1))
            hay[q], hay[q + 1] = hay[q + 1], hay[q]
    return needles, hay


def check_search_kernel(dev):
    from triple_accel_tpu_torch.ops.myers_search import (
        myers_search, myers_search_plain, prepare_myers_needles,
        search_halo, suggest_own_len)
    from triple_accel_tpu_torch.ops.search_common import window_span

    rng = np.random.default_rng(4048)
    cases, worst = 0, 0

    def run(hay, nd, own_len, halo, anchored, damerau, warps, what):
        nonlocal cases, worst
        hay_d = torch.from_numpy(hay).to(dev)
        got = myers_search(hay_d, nd, own_len=own_len, halo=halo,
                           anchored=anchored, damerau=damerau, warps=warps)
        torch.cuda.synchronize()
        ref = myers_search_plain(hay_d, nd, own_len=own_len, halo=halo,
                                 anchored=anchored, damerau=damerau)
        err = int((got.to(torch.int64) - ref.to(torch.int64)).abs().max())
        worst = max(worst, err)
        check(err == 0, f"myers_search != plain: {what} damerau={damerau} "
                        f"anchored={anchored}")
        cases += 1

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
                    halo = search_halo(window_span(m, k, 1, 0), n)
                    # the tail segment is shorter than own_len (n is odd)
                    own_len = min(suggest_own_len(iter_len, halo), 4096)
                run(hay[:iter_len].copy(), nd, own_len, halo, anchored,
                    damerau, None, f"m={m}")
    for m, n, own, halo, anchored, damerau, warps in SEARCH_EDGE_CASES:
        needles, hay = search_edge_input(rng, m, n)
        nd = prepare_myers_needles(list(needles), m, device=dev)
        run(hay, nd, own, halo, anchored, damerau, warps,
            f"edge m={m} n={n} own_len={own} halo={halo} warps={warps}")
    # a dictionary launch: DICT_CHECK_NUM needles of one length, a grid
    # row each, every needle planted
    m, n = 24, CHECK_HAY_BYTES[0]
    hay = rng.integers(65, 69, n).astype(np.uint8)
    needles = [rng.integers(65, 69, m).astype(np.uint8)
               for _ in range(DICT_CHECK_NUM)]
    for i, pos in enumerate(rng.integers(0, n - m, DICT_CHECK_NUM)):
        hay[pos: pos + m] = needles[i]
    nd = prepare_myers_needles(needles, m, device=dev)
    halo = search_halo(window_span(m, k, 1, 0), n)
    for damerau in (False, True):
        run(hay, nd, suggest_own_len(n, halo), halo, False, damerau, None,
            f"{DICT_CHECK_NUM} needles in one launch")
    edge = check_dictionary_edge(dev, rng)
    return cases + edge[0], max(worst, edge[1]), edge[2]


def check_dictionary_edge(dev, rng):
    """A dictionary group whose distances pass torch.nonzero's 2^31 - 1
    elements (DICT_EDGE): the launches of `_many_launch_plan`, each's hits
    collected as the dictionary collects them, and every launch's
    distances held against the plain version (DICT_EDGE_PLAIN needles at
    a time).  Returns (cases, worst error, the launches' needle counts)."""
    import importlib

    from triple_accel_tpu_torch.ops.myers_search import (
        collect_hits, myers_search, myers_search_plain,
        prepare_myers_needles, search_halo, suggest_own_len)
    from triple_accel_tpu_torch.ops.search_common import window_span

    lev = importlib.import_module("triple_accel_tpu_torch.levenshtein")
    num, n, m = DICT_EDGE
    k = K_SEARCH
    # past the byte budget, so that the element cap cuts the group: a
    # launch of 32,767 needles holds 2^31 - 2^16 distances
    saved, lev._MANY_LAUNCH_BYTES = lev._MANY_LAUNCH_BYTES, 1 << 40
    try:
        plan = lev._many_launch_plan(num, n, False, 32,
                                     suggest_own_len(n, 32))
    finally:
        lev._MANY_LAUNCH_BYTES = saved
    hay = rng.integers(65, 69, n).astype(np.uint8)
    needles = rng.integers(65, 69, (num, m)).astype(np.uint8)
    # planted copies across the launches' edge and at both ends
    for i in (0, 1, num // 2, num - 3, num - 2, num - 1):
        pos = int(rng.integers(0, n - m))
        hay[pos: pos + m] = needles[i]
    hay_d = torch.from_numpy(hay).to(dev)
    halo = search_halo(window_span(m, k, 1, 0), n)
    own_len = suggest_own_len(n, halo)
    check(halo == 32 and len(plan) == 2
          and (plan[0][1] - plan[0][0]) * (n + 1) > (1 << 31) - 2 * (n + 1)
          and num * (n + 1) > (1 << 31) - 1,
          f"the nonzero edge case is not cut at the edge: {plan}")
    nd = prepare_myers_needles(list(needles), m, device=dev)
    cases, worst, hits = 0, 0, 0
    for lo, hi in plan:
        dist = myers_search(hay_d, nd[lo:hi], own_len=own_len, halo=halo)
        ni, _, _ = collect_hits(dist, k)
        hits += ni.size
        ref_hits = 0
        for s in range(lo, hi, DICT_EDGE_PLAIN):
            e = min(s + DICT_EDGE_PLAIN, hi)
            ref = myers_search_plain(hay_d, nd[s:e], own_len=own_len,
                                     halo=halo)
            err = int((dist[s - lo: e - lo].to(torch.int64)
                       - ref.to(torch.int64)).abs().max())
            ref_hits += int((ref <= k).sum())
            worst = max(worst, err)
            check(err == 0, f"myers_search != plain in the dictionary "
                            f"launch [{lo}, {hi}) at needles [{s}, {e})")
            del ref
        check(ni.size == ref_hits,
              f"collect_hits over [{lo}, {hi}) found {ni.size} hits, the "
              f"plain version {ref_hits}")
        del dist
        cases += 1
    check(hits >= 6, f"the planted copies gave {hits} hits")
    return cases, worst, [hi - lo for lo, hi in plan]


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


def lane_edge_pairs(rng, unit_k: int, cells: int, max_m: int):
    """Copies with an adjacent swap on a diagonal at a lane edge of the
    band kernel's warp regime: b starts with d filler bytes, so the path
    runs at band cell unit_k + d, for the d that put it on a lane's first
    cell (cells * l) or on the last cell of the lane before; up to 8 pairs,
    len(a) in [6, max_m]."""
    a_list, b_list = [], []
    for e in range(cells, 2 * unit_k + 1, cells):
        for d in (e - unit_k - 1, e - unit_k):
            if not 0 <= d <= unit_k or len(a_list) >= 8:
                continue
            m = int(rng.integers(6, max_m + 1))
            a = rng.integers(65, 69, m).astype(np.uint8)
            b = a.copy()
            q = int(rng.integers(1, m - 2))
            b[q], b[q + 1] = b[q + 1], b[q]
            a_list.append(a)
            b_list.append(np.concatenate(
                [rng.integers(65, 69, d).astype(np.uint8), b]))
    return a_list, b_list


# band cells the walk's checks run along: the band's two ends and both
# sides of the first two 16-code word edges
WALK_EDGE_CELLS = (0, 15, 16, 31, 32)
# costs under which a mismatch costs more than two gaps: every step of the
# walk is a gap, so a pair X^m, Y^(m + unit_k) walks m + n steps
LONGEST_WALK_COSTS = (3, 1, 0, None)


def walk_edge_pairs(rng, unit_k: int, max_m: int):
    """Pairs whose traceback walks run along band cells 0, 15, 16, 31, 32
    and W - 1, W = 2 * unit_k + 1 (those inside the band): at offset e =
    cell - unit_k, a = F + s and b = s + G with |e| filler bytes each (e <
    0: deletions first), or a = s + F and b = G + s (e > 0), s an ACGT
    string three times |e| long or as long as max_m allows, so that two gap
    runs beat the mismatches of the shifted diagonal; then a pair whose
    walk ends with a transposition (a starts "CA", b "AC") and an empty
    a against a non-empty b.  len(a) <= len(b) <= len(a) + unit_k and
    len(a) <= max_m hold for every pair."""
    W = 2 * unit_k + 1
    a_list, b_list = [], []
    for cell in sorted({c for c in WALK_EDGE_CELLS if c < W} | {W - 1}):
        e = cell - unit_k
        s = ACGT[rng.integers(0, 4, max(1, min(3 * abs(e) + 16,
                                               max_m - abs(e))))]
        fill_a = np.full(abs(e), ord("X"), np.uint8)
        fill_b = np.full(abs(e), ord("Y"), np.uint8)
        if e < 0:
            a, b = np.concatenate([fill_a, s]), np.concatenate([s, fill_b])
        else:
            a, b = np.concatenate([s, fill_a]), np.concatenate([fill_b, s])
        if len(a) <= max_m:
            a_list.append(a)
            b_list.append(b)
    s = ACGT[rng.integers(0, 4, max(0, min(40, max_m - 2)))]
    a_list.append(np.concatenate([np.frombuffer(b"CA", np.uint8), s]))
    b_list.append(np.concatenate([np.frombuffer(b"AC", np.uint8), s]))
    a_list.append(np.empty(0, np.uint8))
    b_list.append(ACGT[rng.integers(0, 4, min(unit_k, 7))])
    return a_list, b_list


def longest_walk_pair(unit_k: int, max_m: int):
    """The pair whose walk is as long as the walk's bound allows: m =
    max_m, n = m + unit_k, no character in common; under
    LONGEST_WALK_COSTS all m + n = 2 * max_m + unit_k steps are gaps (the
    bound, `steps`, is one more)."""
    return (np.full(max_m, ord("X"), np.uint8),
            np.full(max_m + unit_k, ord("Y"), np.uint8))


def walk_cells(seq_row: np.ndarray, m: int, n: int, unit_k: int):
    """The band cells a walked edit stream (one row of the walk's output,
    reverse walk order) passes through, from (m, n) to (0, 0)."""
    i, j, cells = m, n, [n - m + unit_k]
    step = {0: (1, 1), 1: (1, 1), 2: (0, 1), 3: (1, 0), 4: (2, 2)}
    for v in seq_row.tolist():
        if v < 0:
            break
        di, dj = step[v]
        i, j = i - di, j - dj
        cells.append(j - i + unit_k)
    return cells


def band_lane_cases():
    """(band W, cells a lane, lanes a pair) for the warp regime of the band
    kernel: every lane map at its group's edge (the largest odd W it
    holds), one cell past the 16-lane edge and past the 32-lane edge, and
    the maps the plan picks for the bands `levenshtein_k_batch` runs (2^k +
    1 cells) at a one-pair and at a full batch."""
    from triple_accel_tpu_torch.ops import lev_band as lb

    cases = []
    for c in lb.WARP_CELLS:
        for g in lb.WARP_LANES:
            cases.append((g * c - 1 + (g * c) % 2, c, g))
        cases.append((16 * c + 1, c, 32))  # one cell into lane 16
    for c, c_next in zip(lb.WARP_CELLS, lb.WARP_CELLS[1:]):
        cases.append((32 * c + 1, c_next, 32))  # one cell past 32 lanes
    for W in (9, 65, 129, 513):
        for batch in (1, None):
            plan = lb.band_plan(8, (W - 1) // 2, batch=batch)
            cases.append((W, plan["cells_per_lane"], plan["lanes_per_pair"]))
    return sorted(set(cases))


def band_block_cases():
    """(band W, cells a lane, warps a pair) for the block regime of the
    band kernel: one cell short of a warp's cells at 1, 2, 3, 16, 17 and
    18 warps (the two launch bounds' edges), one cell into the last of
    them (bands up to MAX_WIDE_BAND), and the maps
    the plan picks for the bands past 544 cells that `levenshtein_k_batch`
    and the front door run (2^k + 1 untraced; traced 2,017 and 9,281, the
    widest) at a one-pair and at a full batch."""
    from triple_accel_tpu_torch.ops import lev_band as lb

    cases = []
    for c in lb.BLOCK_CELLS:
        for nw in range(1, lb.BLOCK_MAX_WARPS[c] + 1):
            if nw not in (1, 2, 3, 16, 17, 18):
                continue
            cases.append((32 * c * nw - 1, c, nw))
            if nw > 1:
                cases.append((32 * c * (nw - 1) + 1, c, nw))
    # the plan takes no band past MAX_WIDE_BAND (a wrapper refuses it)
    cases = [x for x in cases if x[0] <= lb.MAX_WIDE_BAND]
    for W in (545, 1025, 2017, 2049, 4097, 8193, 9281):
        for batch in (1, None):
            plan = lb.band_plan(8, (W - 1) // 2, batch=batch)
            cases.append((W, plan["cells_per_lane"], plan["warps_per_pair"]))
    return sorted(set(cases))


def block_plan(max_m: int, unit_k: int, cells: int, warps: int) -> dict:
    """A block-regime plan of the band kernel at a given map."""
    from triple_accel_tpu_torch.ops.lev_band import band_plan

    return dict(band_plan(max_m, 272), regime="wide",
                cells_per_lane=cells, lanes_per_pair=32 * warps,
                warps_per_pair=warps, threads=32 * warps, pairs_per_block=1)


def lane_plan(max_m: int, unit_k: int, cells: int, lanes: int,
              threads: int) -> dict:
    """A warp-regime plan of the band kernel at a given lane map."""
    from triple_accel_tpu_torch.ops.lev_band import band_plan

    return dict(band_plan(max_m, unit_k), regime="warp",
                cells_per_lane=cells, lanes_per_pair=lanes, threads=threads,
                pairs_per_block=threads // lanes)


def costs_tuple(costs):
    return (costs.mismatch_cost, costs.gap_cost, costs.start_gap_cost,
            costs.transpose_cost_or_zero, costs.allow_transpose)


def band_errors(got_d, got_codes, ref_d, ref_codes, t, unit_k: int,
                walk: bool) -> int:
    """Largest disagreement between the kernel's and the plain version's
    distances, argmin codes (rows 1..m of each pair: the kernel writes no
    others) and, with `walk`, the runs the walk kernel K10 walks from the
    kernel's codes and the plain walk from the plain codes."""
    from triple_accel_tpu_torch.ops.trace_walk import (
        trace_walk, trace_walk_plain)

    err = int((got_d.to(torch.int64) - ref_d.to(torch.int64)).abs().max())
    if got_codes is None:
        return err
    rows = got_codes.shape[1]
    live = (torch.arange(rows, device=got_codes.device)[None, :]
            < t[2][:, None])[:, :, None]
    err = max(err, int(((got_codes != ref_codes) & live).any()))
    if walk:
        err = max(err, runs_err(trace_walk(got_codes, *t, unit_k=unit_k),
                                trace_walk_plain(ref_codes, *t,
                                                 unit_k=unit_k)))
    return err


def runs_err(got, ref) -> int:
    """Largest disagreement of two walks' (runs, counts): 0 where both are
    equal, the run counts and every packed run."""
    (g_runs, g_counts), (r_runs, r_counts) = got, ref
    if g_counts.shape != r_counts.shape or g_runs.shape != r_runs.shape:
        return 1 << 30
    err = int((g_counts.cpu().long() - r_counts.cpu().long()).abs().max()) \
        if g_counts.numel() else 0
    if g_runs.numel():
        err = max(err, int((g_runs.cpu().long()
                            - r_runs.cpu().long()).abs().max()))
    return err


def pair_runs(runs: torch.Tensor, counts: torch.Tensor, p: int):
    """Pair p's runs of a walk's (runs, counts)."""
    lo = int(counts[:p].sum())
    return runs[lo:lo + int(counts[p])]


def check_band_kernels(dev):
    """The band kernels over a seeded grid of cost models, band widths and
    lengths: the short regime, the long one (rows >= 16384, band 513), the
    block regime (bands 1025 and 8193 at the plan's maps, then every map
    of `band_block_cases` on its warp edges, with swaps on the diagonals
    of the warp edges; the traced kernel's cluster regime has
    `check_band_cluster`), and every lane map of the warp
    regime at its lane and group edges (`band_lane_cases`), at a batch
    that leaves its last warp part empty and at a full one, with swaps on
    the diagonals of the lane edges.  Distances, codes and the edit
    streams walked from them (by K10 from the kernel's codes, by the plain
    walk from the plain version's) equal the plain version's exactly."""
    from triple_accel_tpu_torch.ops.band_scan import band_scan_distance
    from triple_accel_tpu_torch.ops.lev_band import (
        MAX_UNIT_K, band_distance, band_plan, band_trace,
        prepare_band_tensors)
    from triple_accel_tpu_torch.types import (
        EditCosts, LEVENSHTEIN_COSTS, RDAMERAU_COSTS)

    rng = np.random.default_rng(777)
    short = [(4, 64, 2048), (32, 1024, 1024), (100, 700, 512),
             (512, 2000, 96)]
    long_ = [(256, 16_400, 16)]
    wide = [(512, 1100, 12), (MAX_UNIT_K, 1500, 12)]
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
                                unit_k, walk=True))
                worst = max(worst, err)
                check(err == 0, f"band kernels != plain at costs={ct} "
                                f"unit_k={unit_k} max_m={max_m}")
                cases[regime] += 2  # the untraced and the traced kernel
                del got_codes, ref_codes
    cases["block_edges"] = 0
    for q, (W, cells, warps) in enumerate(band_block_cases()):
        unit_k, max_m = (W - 1) // 2, 60
        ct = costs_tuple((RDAMERAU_COSTS, EditCosts(*AFFINE))[q % 2])
        a_list, b_list = band_cases(rng, 24, max_m, unit_k)
        a_e, b_e = lane_edge_pairs(rng, unit_k, 32 * cells, max_m)
        t = prepare_band_tensors(a_list + a_e, b_list + b_e, unit_k, max_m,
                                 device=dev)
        plan = block_plan(max_m, unit_k, cells, warps)
        got_d = band_distance(*t, unit_k=unit_k, costs_t=ct, plan=plan)
        got_dt, got_codes = band_trace(*t, unit_k=unit_k, costs_t=ct,
                                       plan=plan)
        torch.cuda.synchronize()
        ref_d, ref_codes = band_scan_distance(
            *t, unit_k=unit_k, costs_t=ct, trace_on=True)
        err = max(
            band_errors(got_d, None, ref_d, None, t, unit_k, False),
            band_errors(got_dt, got_codes, ref_d, ref_codes, t, unit_k,
                        walk=True))
        worst = max(worst, err)
        check(err == 0, f"band kernels != plain at costs={ct} W={W} "
                        f"{warps} warps x 32 lanes x {cells} cells")
        cases["block_edges"] += 2
        del got_codes, ref_codes
    cases["lane_edges"] = 0
    for q, (W, cells, lanes) in enumerate(band_lane_cases()):
        unit_k, max_m = (W - 1) // 2, 60
        per_warp = 32 // lanes
        # with and without transpositions at each batch, in turns across
        # the cases
        costs_pair = (RDAMERAU_COSTS, EditCosts(*AFFINE))[::1 - 2 * (q % 2)]
        for costs, n_pairs, threads in (
                (costs_pair[0], max(per_warp - 1, 2), 32),
                (costs_pair[1], 64 * per_warp + 1, 256)):
            ct = costs_tuple(costs)
            a_list, b_list = band_cases(rng, n_pairs, max_m, unit_k)
            a_e, b_e = lane_edge_pairs(rng, unit_k, cells, max_m)
            t = prepare_band_tensors(a_list + a_e, b_list + b_e, unit_k,
                                     max_m, device=dev)
            plan = lane_plan(max_m, unit_k, cells, lanes, threads)
            got_d = band_distance(*t, unit_k=unit_k, costs_t=ct, plan=plan)
            got_dt, got_codes = band_trace(*t, unit_k=unit_k, costs_t=ct,
                                           plan=plan)
            torch.cuda.synchronize()
            ref_d, ref_codes = band_scan_distance(
                *t, unit_k=unit_k, costs_t=ct, trace_on=True)
            err = max(
                band_errors(got_d, None, ref_d, None, t, unit_k, False),
                band_errors(got_dt, got_codes, ref_d, ref_codes, t,
                            unit_k, walk=True))
            worst = max(worst, err)
            check(err == 0, f"band kernels != plain at costs={ct} W={W} "
                            f"lanes {lanes} x cells {cells}, "
                            f"{len(a_list) + len(a_e)} pairs")
            cases["lane_edges"] += 2
    return cases, worst


def cluster_plan(max_m: int, unit_k: int, ctas: int, warps: int,
                 full_band: bool = False) -> dict:
    """A plan of K4's cluster regime at a given cluster: `ctas` CTAs of
    `warps` warps (a ring over the pair's strips of 512 columns, however
    many), with its strips over every band column where `full_band` (or
    where the batch needs it: `lev_band._full_band`)."""
    from triple_accel_tpu_torch.ops import lev_band as lb

    from triple_accel_tpu_torch.ops.band_scan import code_words

    plan = lb.band_plan(max_m, 2 * lb.MAX_UNIT_K, True, max_n=0)
    W = 2 * unit_k + 1
    return dict(plan, ctas_per_pair=ctas, threads=32 * warps,
                warps_per_pair=ctas * warps,
                lanes_per_pair=32 * ctas * warps, code_words=code_words(W),
                code_bytes_per_pair=max(max_m, 1) * code_words(W) * 4,
                full_band=full_band or lb._full_band(max_m, unit_k))


def cluster_pairs(rng, n_pairs: int, max_m: int, max_n: int, unit_k: int):
    """Pairs for K4's cluster regime: len(a) <= len(b) <= min(len(a) +
    unit_k, max_n); a over a four-letter alphabet with NUL bytes (pads are
    0 too) in every fourth, b a copy with overwritten bytes and adjacent
    swaps, grown by insertions; every third pair as long as allowed
    (max_n: the columns at the cluster's edge), every fifth at max_m
    rows; an empty pair and an empty a against a non-empty b."""
    a_list, b_list = [], []
    for p in range(n_pairs):
        m = max_m if p % 5 == 0 else int(rng.integers(0, max_m + 1))
        a = rng.integers(65, 69, m).astype(np.uint8)
        if m and p % 4 == 0:
            a[rng.integers(0, m, 3)] = 0
        b = a.copy()
        if m:
            b[rng.integers(0, m, m // 20 + 1)] = rng.integers(65, 69, m // 20 + 1)
        if m > 1:
            for q in rng.integers(0, m - 1, m // 50 + 2).tolist():
                b[q], b[q + 1] = int(b[q + 1]), int(b[q])
        top = min(m + unit_k, max_n)
        n = top if p % 3 == 0 else int(rng.integers(m, top + 1))
        b = np.insert(b, rng.integers(0, m + 1, n - m),
                      rng.integers(65, 69, n - m).astype(np.uint8))
        a_list.append(a)
        b_list.append(b)
    a_list[0] = b_list[0] = np.empty(0, np.uint8)
    a_list[1] = np.empty(0, np.uint8)
    b_list[1] = b_list[1][:unit_k]
    return a_list, b_list


def cluster_edge_pairs(rng, unit_k: int, max_m: int, max_n: int):
    """Pairs whose transpositions end on the first two columns of lanes
    (16k, 16k + 1: D(i - 2, j - 2) and b[j - 2] come from the lane, warp
    or CTA on the left): b is a copy of a with adjacent swaps at every
    position q = 14, 15 (mod 16) of a block, shifted by d = 0, 1 or 15
    bytes inserted in front (the diagonal moves by d columns); the last
    pair as long as `max_n` allows.  len(a) <= len(b) <= len(a) + unit_k."""
    a_list, b_list = [], []
    for d in (0, 1, 15):
        if d > unit_k:
            continue
        m = min(max_m, max_n - d)
        a = ACGT[rng.integers(0, 4, m)]
        b = a.copy()
        for q in range(14 if d % 2 == 0 else 15, m - 1, 16 * (1 + d % 3)):
            b[q], b[q + 1] = b[q + 1], b[q]
        b = np.concatenate([ACGT[rng.integers(0, 4, d)], b])
        a_list.append(a)
        b_list.append(b)
    a, b = a_list[-1], b_list[-1]
    grow = min(unit_k - (len(b) - len(a)), max_n - len(b))
    b_list[-1] = np.concatenate([b, ACGT[rng.integers(0, 4, grow)]])
    return a_list, b_list


# K4's cluster regime on the card: (unit_k, rows, longest b, CTAs a
# cluster, warps a CTA, pairs).  Every cluster size, and the maps the plan
# picks: band 9,409 just past the shared-memory plan (b strings of 4,700
# bytes), band 20,001 (unit_k 10,000, the `past_plan` cell's map), the
# widest the cluster holds (81,917-byte b strings, band 163,521); the
# longest b of each case fills its last lane's columns to n + 2.
CLUSTER_CHECKS = (
    (4704, 700, 4_700, 1, 10, 6),
    (4704, 900, 4_605, 2, 5, 6),
    (10_000, 800, 10_749, 3, 7, 5),
    (4704, 1500, 6_141, 4, 3, 6),
    (4704, 700, 5_117, 5, 2, 6),
    (10_000, 600, 9_213, 6, 3, 4),
    (4704, 900, 3_581, 7, 1, 6),
    (10_000, 500, 10_000, 8, 3, 4),
    (10_000, 600, 10_237, 2, 10, 4),
    (81_760, 160, 81_917, 8, 20, 3),
)


def ring_edge_pair(rng, m: int, unit_k: int):
    """A pair whose cheapest path runs on the band's right edge (b =
    unit_k bytes, then a), with adjacent swaps that end on each strip's
    first column in the first row whose band reaches it (row 512 s -
    unit_k): their transpositions read D two rows up, which comes from the
    strip on the left before the band reaches this one."""
    a = ACGT[rng.integers(0, 4, m)]
    b = a.copy()
    for s in range(1, (m + unit_k) // 512 + 1):
        q = 512 * s - unit_k - 2
        if 0 <= q and q + 1 < m:  # a: X N, b: N X
            a[q + 1] = b[q] = ord("N")
            b[q + 1] = a[q]
    return a, np.concatenate([ACGT[rng.integers(0, 4, unit_k)], b])


# K4's cluster regime as a ring: fewer warps than strips of 512 columns
# (unit_k, rows, longest b, CTAs a cluster, warps a CTA, pairs, strips over
# every band column): the plan's bands (9,409; 10,017 as in `band_wide`
# case (e)) over 11 to 13 strips on 2 to 8 warps, a band of 2,001 cells
# on 3 warps, narrow bands whose strips run disjoint rows on 1 and 2
# warps, and the strips over every band column (`full_band`, the path
# past the INF rule) at two of them.
RING_CHECKS = (
    (4704, 600, 5_300, 1, 2, 4, False),
    (5008, 1500, 6_500, 2, 4, 3, False),
    (4704, 400, 5_104, 3, 1, 4, True),
    (1000, 4000, 5_000, 1, 3, 4, False),
    (8, 3000, 3_000, 1, 1, 6, False),
    (40, 6000, 6_040, 2, 1, 6, True),
)


def check_band_cluster(dev):
    """K4's cluster regime against the plain version on the card, under
    the four cost models: distances and every code word of rows 1..m,
    bit for bit, at CLUSTER_CHECKS (`cluster_pairs`, and
    `cluster_edge_pairs`: transpositions across lane, warp and CTA edges)
    and at RING_CHECKS (the same, and `ring_edge_pair`: transpositions at
    each strip's first row).  K10 over this regime's codes:
    `check_trace_walk_kernel`."""
    from triple_accel_tpu_torch.ops.band_scan import band_scan_distance
    from triple_accel_tpu_torch.ops.lev_band import (
        band_trace, prepare_band_tensors)
    from triple_accel_tpu_torch.types import (
        EditCosts, LEVENSHTEIN_COSTS, RDAMERAU_COSTS)

    rng = np.random.default_rng(1100)
    worst, cases = 0, 0
    for q, (unit_k, max_m, max_n, ctas, warps, n_pairs, full) in enumerate(
            [c + (False,) for c in CLUSTER_CHECKS] + list(RING_CHECKS)):
        a_list, b_list = cluster_pairs(rng, n_pairs, max_m, max_n, unit_k)
        a_e, b_e = cluster_edge_pairs(rng, unit_k, max_m, max_n)
        if q >= len(CLUSTER_CHECKS):
            a_r, b_r = ring_edge_pair(rng, max_n - unit_k - 8, unit_k)
            a_e, b_e = a_e + [a_r], b_e + [b_r]
        t = prepare_band_tensors(a_list + a_e, b_list + b_e, unit_k, max_m,
                                 device=dev)
        plan = cluster_plan(max_m, unit_k, ctas, warps, full_band=full)
        for costs in (LEVENSHTEIN_COSTS, RDAMERAU_COSTS, EditCosts(*AFFINE),
                      EditCosts(3, 2, 1, 2)):
            ct = costs_tuple(costs)
            got_d, got_codes = band_trace(*t, unit_k=unit_k, costs_t=ct,
                                          plan=plan)
            torch.cuda.synchronize()
            ref_d, ref_codes = band_scan_distance(
                *t, unit_k=unit_k, costs_t=ct, trace_on=True)
            err = band_errors(got_d, got_codes, ref_d, ref_codes, t, unit_k,
                              walk=False)
            worst = max(worst, err)
            check(err == 0, f"band_trace in a cluster != plain at costs={ct}"
                            f" unit_k={unit_k} {ctas} x {warps} warps")
            cases += 1
            del got_codes, ref_codes
    return cases, worst


# K10's launch shapes at their edges, beside the plan's (the checks'
# batches are few pairs: `trace_walk.WALK_FEW`): (lanes a pair, tile rows,
# window words, threads a block): the many-pairs plan
# (`trace_walk.WALK_MANY`), one lane staging alone with two-row tiles
# (every transposition crosses a tile) and one-word windows (every gap
# steps out sideways), a whole warp a pair with three-row tiles, four
# lanes with 64-row tiles and 16-word windows in blocks of one warp, and
# 16 lanes in blocks of 256 threads (groups left empty in a block but the
# batch's first)
WALK_CHECK_PLANS = ((4, 64, 2, 128), (1, 2, 1, 32), (32, 3, 2, 64),
                    (4, 64, 16, 32), (16, 32, 8, 256))


def walk_gap_pairs(rng, length: int, gap: int):
    """Pairs whose walks leave a tile's window sideways: s1 + s2 against s1
    + Y^gap + s2 (a consume-b run of `gap` steps, which moves the band cell
    left), s1 + X^gap + s2 against s1 + s2 + s3 (an insertion run of gap
    steps at the end, then a deletion run back to the centre), and s1 + s2
    against a copy with adjacent swaps every 5 bytes (transpositions on
    every row parity and tile edge).  s2 is more than 2.5 gap long, so the
    gap runs are the cheapest alignments; n - m <= gap."""
    s1 = ACGT[rng.integers(0, 4, length // 4)]
    s2 = ACGT[rng.integers(0, 4, length - length // 4)]
    s3 = ACGT[rng.integers(0, 4, gap)]
    x = np.full(gap, ord("X"), np.uint8)
    y = np.full(gap, ord("Y"), np.uint8)
    sw = np.concatenate([s1, s2])
    for q in range(0, len(sw) - 1, 5):
        sw[q], sw[q + 1] = int(sw[q + 1]), int(sw[q])
    return ([np.concatenate([s1, s2]), np.concatenate([s1, x, s2]),
             np.concatenate([s1, s2])],
            [np.concatenate([s1, y, s2]), np.concatenate([s1, s2, s3]), sw])


def check_trace_walk_kernel(dev):
    """The walk kernel K10 against its plain version (`trace_walk_plain`):
    every pair's run count and packed runs, at the plan's launch shape and
    at WALK_CHECK_PLANS.  On codes from K4 in each of its regimes (warp,
    block, the cluster regime as a ring of fewer warps than strips at a
    forced narrow plan and at band 16,385, and at band 16,385 as the plan
    gives it),
    under a cost model with transpositions and one without: edited pairs
    with m = 0 and empty pairs (`band_cases`), walks along band cells 0,
    15, 16, 31, 32 and W - 1 and a transposition as a walk's last step
    (`walk_edge_pairs`); gap runs that leave the window sideways and
    transpositions across tile edges (`walk_gap_pairs`, bands 321 and
    2,049); batches that leave groups of a block empty; then the longest
    walk the bound allows (every step a gap, m + n = steps - 1) and random
    codes whose walks leave the matrix."""
    from triple_accel_tpu_torch.ops.band_scan import code_words
    from triple_accel_tpu_torch.ops.lev_band import (
        MAX_UNIT_K, band_trace, prepare_band_tensors)
    from triple_accel_tpu_torch.ops.trace_walk import (
        trace_walk, trace_walk_plain, walk_plan)
    from triple_accel_tpu_torch.types import EditCosts, RDAMERAU_COSTS

    rng = np.random.default_rng(1010)
    worst, cases = 0, 0

    def compare(codes, t, unit_k, what):
        nonlocal worst, cases
        ref = trace_walk_plain(codes, *t, unit_k=unit_k)
        got = None
        for shape in [None, *WALK_CHECK_PLANS]:
            plan = None if shape is None else dict(zip(
                ("lanes", "tile_rows", "window", "threads"), shape))
            got = trace_walk(codes, *t, unit_k=unit_k, plan=plan)
            err = runs_err(got, ref)
            worst = max(worst, err)
            check(err == 0, f"trace_walk != plain walk: {what}, plan "
                            f"{plan or walk_plan(2 * unit_k + 1, len(t[2]))}")
            cases += 1
        return got

    regimes = (("warp", 16, 80, 33, None),
               ("wide", 600, 2500, 9, None),
               ("ring_forced", 16, 1200, 9, cluster_plan(1200, 16, 1, 1)),
               ("ring", 2 * MAX_UNIT_K, 200, 3,
                cluster_plan(200, 2 * MAX_UNIT_K, 1, 2, full_band=True)),
               ("cluster", 2 * MAX_UNIT_K, 200, 3, None))
    for costs in (RDAMERAU_COSTS, EditCosts(*AFFINE)):
        ct = costs_tuple(costs)
        for regime, unit_k, max_m, n_pairs, plan in regimes:
            a_list, b_list = band_cases(rng, n_pairs, max_m, unit_k)
            a_e, b_e = walk_edge_pairs(rng, unit_k, max_m)
            t = prepare_band_tensors(a_list + a_e, b_list + b_e, unit_k,
                                     max_m, device=dev)
            _, codes = band_trace(*t, unit_k=unit_k, costs_t=ct, plan=plan)
            runs, counts = compare(codes, t, unit_k, f"{regime} costs={ct}")
            if ct[4]:  # the transposition pair's walk ends with one
                last = pair_runs(runs, counts, len(a_list) + len(a_e) - 2)
                check(int(last[-1]) & 7 == 4,
                      f"{regime}: the transposition is not the last step")
        for unit_k, length, gap in ((160, 600, 150), (1024, 1200, 300)):
            a_g, b_g = walk_gap_pairs(rng, length, gap)
            t = prepare_band_tensors(a_g * 6, b_g * 6, unit_k, length + gap,
                                     device=dev)
            _, codes = band_trace(*t, unit_k=unit_k, costs_t=ct)
            compare(codes, t, unit_k, f"gap runs at band {2 * unit_k + 1}"
                                      f" costs={ct}")
    a, b = longest_walk_pair(16, 64)
    t = prepare_band_tensors([a] * 35, [b] * 35, 16, 64, device=dev)
    _, codes = band_trace(*t, unit_k=16,
                          costs_t=costs_tuple(EditCosts(*LONGEST_WALK_COSTS)))
    runs, counts = compare(codes, t, 16, "the longest walk")
    steps = 2 * 64 + 16 + 1
    check(int((pair_runs(runs, counts, 0) >> 3).sum()) == steps - 1,
          "the longest walk does not fill its bound but the last step")
    B, unit_k, max_m = 45, 16, 48
    W = 2 * unit_k + 1
    m = torch.from_numpy(rng.integers(0, max_m + 1, B).astype(np.int32))
    t = (torch.from_numpy(rng.integers(65, 69, (B, max_m)).astype(np.uint8)),
         torch.from_numpy(rng.integers(65, 69, (B, max_m + W))
                          .astype(np.uint8)),
         m, m + torch.from_numpy(rng.integers(0, unit_k + 1, B)
                                 .astype(np.int32)))
    codes = torch.from_numpy(rng.integers(
        -(1 << 31), 1 << 31, (B, max_m, code_words(W)), dtype=np.int64)
        .astype(np.int32))
    compare(codes.to(dev), tuple(x.to(dev) for x in t), unit_k,
            "random codes")
    return cases, worst


# the blocked distance kernel's checks: (largest needle, one full-byte
# needle in the batch): the word count a lane the plan picks at each of
# 1, 2, 3, 4, 6, 8, 12, 20, two strips at 20, two strips at 6 (full byte)
BLOCKED_CHECKS = ((1000, False), (2000, False), (3000, False),
                  (4000, False), (6000, False), (8000, False),
                  (12_000, False), (20_000, False), (40_000, False),
                  (9000, True))
BLOCKED_CHECK_PAIRS, BLOCKED_CHECK_COLS = 24, 1000
# the blocked search kernel's checks: (needle length, a full-byte needle
# beside the ACGT one, the (damerau, anchored) modes): the main path's
# needle in every mode, and two strips at 32 lanes x 6 words with the
# restricted-Damerau seeds crossing them
BLOCKED_SEARCH_CHECKS = (
    (LONG_NEEDLE_LEN, False,
     ((False, False), (False, True), (True, False), (True, True))),
    (7000, True, ((True, False),)))
# K6's lane maps (blocked_map_cases): a haystack of BLOCKED_MAP_BYTES cut
# into BLOCKED_MAP_SEGS segments behind a ragged halo, BLOCKED_MAP_WARPS
# warps a block, so the last block holds one segment: the last warp of a
# block empty (32 lanes) or a warp's groups all but one empty (fewer)
BLOCKED_MAP_BYTES, BLOCKED_MAP_SEGS = 700, 9
BLOCKED_MAP_HALO, BLOCKED_MAP_WARPS = 37, 2


def blocked_map_cases():
    """(words a lane, lanes a segment, needle length) for every lane map of
    the blocked kernel's search mode at its edges: one word under a
    group's share (one strip, the top lane a word short) and one word over
    a strip (two strips, the second holding one word of its lane 0); at 4
    lanes also one word under and over a lane's share."""
    from triple_accel_tpu_torch.ops import myers_chunked as mc

    cases = []
    for w in mc.WPT_CHOICES:
        for g in mc.LANE_CHOICES:
            words = {g * w - 1, g * w + 1}
            if g == mc.LANE_CHOICES[0]:
                words |= {w - 1, w + 1}
            cases += [(w, g, 32 * nw - 3 * (nw % 3)) for nw in sorted(words)
                      if nw >= 1]
    return cases


def blocked_map_input(rng, m: int, wpt: int, lanes: int, n: int):
    """Two needles of m bytes (ACGT; a NUL byte in the first) and an ACGT
    haystack of n bytes starting with NUL: windows of the first needle's
    copy around adjacent swaps at its first word edge, its first lane edge
    and its first strip edge (each swap a transposition whose seeds cross
    that edge), planted one after the other, the whole copy when it fits."""
    needles = ACGT[rng.integers(0, 4, (2, m))]
    needles[0, m // 2] = 0
    hay = ACGT[rng.integers(0, 4, n)]
    copy = needles[0].copy()
    edges = [e for e in (31, 32 * wpt - 1, 32 * wpt * lanes - 1)
             if e + 1 < m]
    for e in edges:
        copy[e], copy[e + 1] = copy[e + 1], copy[e]
    if m + 10 <= n:
        hay[5: 5 + m] = copy
    else:
        pos = 5
        for e in sorted(set(edges)):
            lo = max(e - 40, 0)
            win = copy[lo: e + 40][: max(n - pos, 0)]
            hay[pos: pos + len(win)] = win
            pos += len(win) + 7
    hay[0] = 0
    return needles, hay


def blocked_distance_cases(rng, n_pairs: int, max_m: int, full_byte: bool):
    """Pairs for K5 against its plain version.  Needle lengths on both
    sides of a 32-bit word, of a lane's words and of a strip at the word
    count a lane the plan picks for `max_m`, up to `max_m`; texts of at
    most BLOCKED_CHECK_COLS bytes (the plain version pays one step a
    column), edited copies of the needle's start, so long needles meet
    short texts; NUL bytes; an empty needle; with `full_byte`, one needle
    over all 256 byte values.  Needles may be longer than their texts."""
    from triple_accel_tpu_torch.ops.myers_chunked import (
        LANES, WORD, blocked_plan)

    wpt = blocked_plan(max_m, 257 if full_byte else 6)["words_per_lane"]
    lane, strip = WORD * wpt, WORD * wpt * LANES
    edges = [1, 31, 32, 33, lane - 1, lane, lane + 1, strip - 1, strip,
             strip + 1, max_m]
    lengths = sorted({x for x in edges if 0 < x <= max_m})
    lengths += rng.integers(1, max_m + 1,
                            n_pairs - 1 - len(lengths)).tolist()
    a_list, b_list = [np.empty(0, np.uint8)], [ACGT[rng.integers(0, 4, 40)]]
    for p, m in enumerate(lengths):
        a = ACGT[rng.integers(0, 4, m)]
        if full_byte and p == len(lengths) - 1:
            a = np.resize(rng.permutation(256).astype(np.uint8), m)
        a[rng.integers(0, m, 2)] = 0  # NUL bytes: pads are 0 too
        b = edit_acgt(a[: BLOCKED_CHECK_COLS - 20],
                      max(1, min(m, BLOCKED_CHECK_COLS - 20) // 10), rng)
        a_list.append(a)
        b_list.append(b)
    return a_list, b_list


def check_blocked_kernels(dev):
    """K5 and K6 against their plain versions on the card, exactly.  K5:
    the batches of BLOCKED_CHECKS under unit and rDamerau costs.  K6: a
    3,000-byte ACGT needle, and a 7,000-byte one beside a full-byte needle
    (two strips at 6 words a lane), over a 1 MiB haystack with NUL bytes
    and planted copies, unit and rDamerau, anchored and not, unanchored
    over segments whose owned length is not a multiple of 4
    (BLOCKED_SEARCH_CHECKS: the plain version pays a step a column); then
    every lane map at its edges (blocked_map_cases), both cost models in
    turn, every fifth case anchored, over segments that leave the last
    block of BLOCKED_MAP_WARPS warps partly empty."""
    from triple_accel_tpu_torch.ops import myers_chunked as mc
    from triple_accel_tpu_torch.ops.myers_search import prepare_myers_needles
    from triple_accel_tpu_torch.ops.search_common import window_span

    rng = np.random.default_rng(6060)
    d_cases, worst = 0, 0
    for max_m, full_byte in BLOCKED_CHECKS:
        a_list, b_list = blocked_distance_cases(rng, BLOCKED_CHECK_PAIRS,
                                                max_m, full_byte)
        t = mc.prepare_blocked_distance_inputs(a_list, b_list, device=dev)
        for damerau in (False, True):
            got = mc.blocked_distance(*t, damerau=damerau)
            torch.cuda.synchronize()
            ref = mc.blocked_distance_plain(*t, damerau=damerau)
            err = int((got.to(torch.int64) - ref.to(torch.int64)).abs().max())
            worst = max(worst, err)
            check(err == 0, f"blocked_distance != plain at max_m={max_m} "
                            f"full_byte={full_byte} damerau={damerau}")
            d_cases += 1
    s_cases, s_worst = 0, 0
    k = 40
    n = CHECK_HAY_BYTES[1]
    for m, full_byte, modes in BLOCKED_SEARCH_CHECKS:
        hay = ACGT[rng.integers(0, 4, n)]
        hay[:2] = 0
        needles = [ACGT[rng.integers(0, 4, m)], ACGT[rng.integers(0, 4, m)]]
        if full_byte:
            needles[1] = np.resize(rng.permutation(256).astype(np.uint8), m)
        needles[1][0] = 0  # a NUL needle byte against a NUL haystack start
        for pos in [0] + rng.integers(0, n - m, 8).tolist():
            copy = needles[0].copy()
            substitute_acgt(copy, rng.choice(m, 10, replace=False), rng)
            copy[5], copy[6] = copy[6], copy[5]
            hay[pos: pos + m] = copy
        nd = prepare_myers_needles(needles, m, device=dev)
        for damerau, anchored in modes:
            if anchored:
                iter_len, halo = min(m + k, n), 0
                own_len = iter_len
            else:
                iter_len = n
                halo = min(-(-window_span(m, k, 1, 0) // 256) * 256, n)
                own_len = 1027  # the tail of every segment is ragged
            hay_d = torch.from_numpy(hay[:iter_len].copy()).to(dev)
            kw = dict(own_len=own_len, halo=halo, anchored=anchored,
                      damerau=damerau)
            got = mc.blocked_search(hay_d, nd, **kw)
            torch.cuda.synchronize()
            ref = mc.blocked_search_plain(hay_d, nd, **kw)
            err = int((got.to(torch.int64) - ref.to(torch.int64))
                      .abs().max())
            s_worst = max(s_worst, err)
            check(err == 0, f"blocked_search != plain at m={m} "
                            f"damerau={damerau} anchored={anchored}")
            s_cases += 1
    n = BLOCKED_MAP_BYTES
    for q, (wpt, lanes, m) in enumerate(blocked_map_cases()):
        needles, hay = blocked_map_input(rng, m, wpt, lanes, n)
        nd = prepare_myers_needles(list(needles), m, device=dev)
        anchored = q % 5 == 4
        own = n if anchored else -(-n // BLOCKED_MAP_SEGS)
        kw = dict(own_len=own, halo=0 if anchored else BLOCKED_MAP_HALO,
                  anchored=anchored, damerau=q % 2 == 1)
        hay_d = torch.from_numpy(hay).to(dev)
        plan = {"words_per_lane": wpt, "lanes": lanes,
                "warps": BLOCKED_MAP_WARPS}
        got = mc.blocked_search(hay_d, nd, plan=plan, **kw)
        torch.cuda.synchronize()
        err = int((got.to(torch.int64)
                   - mc.blocked_search_plain(hay_d, nd, **kw)
                   .to(torch.int64)).abs().max())
        s_worst = max(s_worst, err)
        check(err == 0, f"blocked_search != plain at the map {lanes} lanes "
                        f"x {wpt} words, m={m}, {kw}")
        s_cases += 1
    # a dictionary launch: 3 needles of 400 chars, planted, both cost
    # models, at a halo of the plan's quantum
    m, n, k = 400, CHECK_HAY_BYTES[1], 40
    hay = ACGT[rng.integers(0, 4, n)]
    needles = [ACGT[rng.integers(0, 4, m)] for _ in range(3)]
    for i, pos in enumerate(rng.integers(0, n - m, 3)):
        copy = needles[i].copy()
        substitute_acgt(copy, rng.choice(m, 8, replace=False), rng)
        hay[pos: pos + m] = copy
    nd = prepare_myers_needles(needles, m, device=dev)
    hay_d = torch.from_numpy(hay).to(dev)
    for damerau in (False, True):
        kw = dict(own_len=2048, damerau=damerau,
                  halo=-(-window_span(m, k, 1, 0) // 256) * 256)
        got = mc.blocked_search(hay_d, nd, **kw)
        torch.cuda.synchronize()
        err = int((got.to(torch.int64) - mc.blocked_search_plain(
            hay_d, nd, **kw).to(torch.int64)).abs().max())
        s_worst = max(s_worst, err)
        check(err == 0, f"blocked_search != plain on 3 needles of {m} "
                        f"chars, damerau={damerau}")
        s_cases += 1
    return (d_cases, worst), (s_cases, s_worst)


# the cost models of benches/tpu_fuzz.py:22 (unit, rDamerau, affine, and
# affine with weighted transpositions)
FUZZ_COSTS = ((1, 1, 0, None), (1, 1, 0, 1), (2, 1, 2, None), (3, 2, 1, 2))
# K7's checks: needle lengths on both sides of the plan's map edges (24 /
# 25: 4 lanes x 6 / x 8 rows; 33; 48 / 49: 4 x 12 / 4 x 16; 96 / 97: 8 x 12
# / 8 x 16; 200: 16 x 16; 385 and 512: 32 x 16, the cap) over a 256 KiB
# haystack cut into ragged segments (the plain version pays a step a
# column of a segment, whatever the haystack's length); then every lane
# map at its edges
# (diag_map_cases) over DIAG_MAP_BYTES in DIAG_MAP_SEGS segments,
# DIAG_MAP_WARPS warps a block, so the last block holds one segment
DIAG_CHECK_LENS = (24, 25, 33, 48, 49, 96, 97, 200, 385, 512)
DIAG_MAP_BYTES, DIAG_MAP_SEGS, DIAG_MAP_WARPS = 800, 9, 2
DIAG_CHECK_BYTES, DIAG_CHECK_OWN = 1 << 18, 509
# K8's checks: (needle length, cost models); segments of 2,500 owned
# columns behind a halo of a window span: every segment spans three or
# more of the kernel's 1,024-column strips
FLAT_CHECKS = ((5, FUZZ_COSTS), (100, FUZZ_COSTS), (700, FUZZ_COSTS[2:]),
               (LONG_NEEDLE_LEN, FUZZ_COSTS[3:]))
FLAT_CHECK_BYTES, FLAT_CHECK_OWN = 1 << 17, 2500
# K9's checks: pairs of up to FLAT_DIST_CHECK_LEN bytes (two of the
# kernel's 4,096-column strips), full and banded at FLAT_DIST_CHECK_UK
FLAT_DIST_CHECK_PAIRS, FLAT_DIST_CHECK_LEN, FLAT_DIST_CHECK_UK = 12, 5000, 64
# the band-entry repro at the card's strip width: a path along the band's
# edge (32 chars inserted at the front, unit_k 32) through a strip boundary
BAND_ENTRY_LEN, BAND_ENTRY_UK = 5000, 32
# K8 and K9 at their launch shape: needles and pair widths one off a
# multiple of a warp's columns (32 x C) and of the strip, copies and
# swaps whose transposition reads D[i-2][j-2] across a lane, a warp and a
# strip boundary; K8 over FLAT_SHAPE_BYTES of haystack
FLAT_SHAPE_BYTES = 1 << 15


def fuzz_costs_t(c):
    """The costs tuple of one entry of FUZZ_COSTS."""
    from triple_accel_tpu_torch.types import EditCosts

    return costs_tuple(EditCosts(*c))


def search_check_input(rng, n: int, m: int, n_copies: int, n_subs: int):
    """A haystack of `n` ACGT bytes starting with NUL bytes, an ACGT needle
    of `m` bytes holding a NUL byte, and `n_copies` copies of the needle
    planted with `n_subs` substitutions and one adjacent swap each (a
    transposition), one at 0."""
    hay = ACGT[rng.integers(0, 4, n)]
    needle = ACGT[rng.integers(0, 4, m)]
    needle[m // 2] = 0
    for pos in [0] + rng.integers(0, n - m, n_copies - 1).tolist():
        copy = needle.copy()
        substitute_acgt(copy, rng.choice(m, min(n_subs, m), replace=False),
                        rng)
        if m > 3:
            copy[1], copy[2] = copy[2], copy[1]
        hay[pos: pos + m] = copy
    hay[:3] = 0  # over the copy at 0
    return hay, needle


def _search_err(got, ref) -> int:
    """Largest difference of two (dist, length) results: distances
    everywhere, lengths where the distance is finite."""
    from triple_accel_tpu_torch.ops.band_scan import INF

    gd, gl = (x.to(torch.int64) for x in got)
    rd, rl = (x.to(torch.int64) for x in ref)
    err = int((gd - rd).abs().max()) if gd.numel() else 0
    fin = rd < INF
    if bool(fin.any()):
        err = max(err, int((gl[fin] - rl[fin]).abs().max()))
    return err


def diag_map_cases():
    """(rows a lane, lanes a segment, needle length) for every lane map of
    K7 at its edges: the group's top lane full (G * R rows) and holding one
    row ((G - 1) * R + 1); at 4 lanes also one row under and over a
    lane's share; lengths up to K7_MAX_NEEDLE and only where G is the
    fewest lanes that hold them at R (the plan's rule)."""
    from triple_accel_tpu_torch.ops import search_diag as sd

    cases = []
    for r in sd.ROW_CHOICES:
        for g in sd.LANE_CHOICES:
            lens = {g * r, (g - 1) * r + 1}
            if g == sd.LANE_CHOICES[0]:
                lens |= {r - 1, r + 1}
            cases += [(r, g, m) for m in sorted(lens)
                      if 1 <= m <= sd.K7_MAX_NEEDLE
                      and g == next(x for x in sd.LANE_CHOICES if x * r >= m)]
    return cases


def diag_map_input(rng, m: int, rows: int, lanes: int, n: int):
    """An ACGT needle of m bytes (a NUL byte in it) and an ACGT haystack of
    n bytes starting with NUL bytes, holding copies of the needle with
    adjacent swaps across the first lane edge (rows R, R + 1) and the top
    lane's first edge (rows (G - 1) * R, (G - 1) * R + 1): each swap a
    transposition that reads row j - 2 from the lane below."""
    hay, needle = search_check_input(rng, n, m, 3, max(1, m // 16))
    copy = needle.copy()
    for e in {rows - 1, (lanes - 1) * rows - 1}:
        if 0 <= e and e + 1 < m:
            copy[e], copy[e + 1] = copy[e + 1], copy[e]
    for pos in (n // 3, (2 * n) // 3):
        if pos + m <= n:
            hay[pos: pos + m] = copy
    return hay, needle


def check_search_diag_kernel(dev):
    """K7 against its plain version on the card, exactly: every needle
    length of DIAG_CHECK_LENS under two of the four cost models each,
    unanchored over ragged segments, then anchored; NUL bytes in the needle
    and at the haystack's start; k at the end-0 candidate's cost m*gap +
    start_gap, so that candidate is in.  Then every lane map at its edges
    (diag_map_cases), the four cost models in turn, every fifth case
    anchored."""
    from triple_accel_tpu_torch.ops import search_diag as sd
    from triple_accel_tpu_torch.ops.search_common import window_span

    rng = np.random.default_rng(7070)
    cases, worst = 0, 0
    for ci, m in enumerate(DIAG_CHECK_LENS):
        hay, needle = search_check_input(rng, DIAG_CHECK_BYTES, m, 8,
                                         max(1, m // 12))
        nd = torch.from_numpy(needle).to(dev)
        for c in (FUZZ_COSTS[ci % 4], FUZZ_COSTS[(ci + 1) % 4]):
            ct = fuzz_costs_t(c)
            k = m * ct[1] + ct[2]
            for anchored in ((False, True) if ci in (0, 9) else (False,)):
                if anchored:
                    it = min(m + max(0, k - ct[2]) // ct[1], len(hay))
                    halo, own = 0, it
                else:
                    it, own = len(hay), DIAG_CHECK_OWN
                    halo = window_span(m, k, ct[1], ct[2])
                hay_d = torch.from_numpy(hay[:it].copy()).to(dev)
                kw = dict(own_len=own, halo=halo, costs_t=ct,
                          anchored=anchored)
                got = sd.search_diag(hay_d, nd, **kw)
                torch.cuda.synchronize()
                err = _search_err(got, sd.search_diag_plain(hay_d, nd, **kw))
                worst = max(worst, err)
                check(err == 0, f"search_diag != plain at m={m} costs={c} "
                                f"anchored={anchored}")
                cases += 1
    n = DIAG_MAP_BYTES
    for q, (rows, lanes, m) in enumerate(diag_map_cases()):
        hay, needle = diag_map_input(rng, m, rows, lanes, n)
        ct = fuzz_costs_t(FUZZ_COSTS[q % 4])
        k = m * ct[1] + ct[2]
        anchored = q % 5 == 4
        if anchored:
            it = min(m + max(0, k - ct[2]) // ct[1], n)
            kw = dict(own_len=it, halo=0, costs_t=ct, anchored=True)
        else:
            it = n
            kw = dict(own_len=-(-n // DIAG_MAP_SEGS),
                      halo=window_span(m, k, ct[1], ct[2]), costs_t=ct)
        hay_d = torch.from_numpy(hay[:it].copy()).to(dev)
        nd = torch.from_numpy(needle).to(dev)
        plan = {"rows_per_lane": rows, "lanes": lanes,
                "warps": DIAG_MAP_WARPS}
        got = sd.search_diag(hay_d, nd, plan=plan, **kw)
        torch.cuda.synchronize()
        err = _search_err(got, sd.search_diag_plain(hay_d, nd, **kw))
        worst = max(worst, err)
        check(err == 0, f"search_diag != plain at the map {lanes} lanes x "
                        f"{rows} rows, m={m}, {kw}")
        cases += 1
    return cases, worst


def flat_boundary_columns(threads: int, cols: int):
    """Columns (1-based, from the first column a block reads) whose
    transposition reads D[i-2][j-2] across a lane boundary (j at a lane's
    first column), across a warp boundary (a warp's first and second
    columns) and across the first strip boundary, at `threads` threads of
    `cols` columns a lane."""
    warp, strip = 32 * cols, threads * cols
    return [5 * cols + 1, warp + 1, warp + 2, 3 * warp + 1, strip + 1,
            strip + 2]


def plant_boundary_swaps(hay, needle, col0s, columns) -> int:
    """Copies of the needle with its chars 1 and 2 swapped, so the swap's
    transposition (needle row 3) falls on column c of the text that starts
    at col0, for (col0, c) in turn, where the copy overlaps none planted
    before; returns how many were planted."""
    m, n = len(needle), len(hay)
    copy = needle.copy()
    copy[1], copy[2] = copy[2], copy[1]
    taken = []
    for col0, col in zip(col0s, columns):
        p = col0 + col - 3
        if p < 0 or p + m > n or any(p < e and b < p + m for b, e in taken):
            continue
        hay[p: p + m] = copy
        taken.append((p, p + m))
    return len(taken)


def check_flat_search_kernel(dev):
    """K8 against its plain version on the card, exactly: FLAT_CHECKS'
    needle lengths and cost models over segments that span several of the
    kernel's column strips (so every strip boundary carries edges, the
    transpositions of the planted copies included), one run over a
    selection of segments, and anchored runs (one segment of m + k
    columns); NUL bytes in the needle and at the haystack's start."""
    from triple_accel_tpu_torch.ops import search_flat as sf
    from triple_accel_tpu_torch.ops.search_common import seg_count
    from triple_accel_tpu_torch.ops.search_common import window_span

    rng = np.random.default_rng(8080)
    cases, worst = 0, 0
    for m, costs_list in FLAT_CHECKS:
        hay, needle = search_check_input(rng, FLAT_CHECK_BYTES, m, 6,
                                         max(1, m // 20))
        nd = torch.from_numpy(needle).to(dev)
        for c in costs_list:
            ct = fuzz_costs_t(c)
            k = max(2, m // 10) * ct[0]
            runs = [(False, None)]
            if m == 100:
                nseg = seg_count(len(hay), FLAT_CHECK_OWN)
                runs += [(False, np.arange(1, nseg, 3)), (True, None)]
            for anchored, segs in runs:
                if anchored:
                    it = min(m + max(0, k - ct[2]) // ct[1], len(hay))
                    halo, own = 0, it
                else:
                    it, own = len(hay), FLAT_CHECK_OWN
                    halo = window_span(m, k, ct[1], ct[2])
                hay_d = torch.from_numpy(hay[:it].copy()).to(dev)
                kw = dict(own_len=own, halo=halo, costs_t=ct,
                          anchored=anchored,
                          segments=None if segs is None
                          else torch.from_numpy(segs).to(dev))
                got = sf.flat_search(hay_d, nd, **kw)
                torch.cuda.synchronize()
                err = _search_err(got, sf.flat_search_plain(hay_d, nd, **kw))
                worst = max(worst, err)
                check(err == 0, f"flat_search != plain at m={m} costs={c} "
                                f"anchored={anchored} selected="
                                f"{segs is not None}")
                cases += 1
    # each kernel variant's launch shape: needles one off a warp's columns,
    # segments one off the strip and a warp's columns, copies across the
    # boundaries (rDamerau and affine with transpositions, affine without)
    for c in (FUZZ_COSTS[1], FUZZ_COSTS[3], FUZZ_COSTS[2]):
        ct = fuzz_costs_t(c)
        threads, cols, _ = sf.SEARCH_SHAPES[bool(ct[4])]
        warp, rj = 32 * cols, threads * cols
        bcols = flat_boundary_columns(threads, cols)
        for m in (warp - 1, warp + 1):
            hay0, needle = search_check_input(rng, FLAT_SHAPE_BYTES, m, 3,
                                              max(1, m // 20))
            nd = torch.from_numpy(needle).to(dev)
            k = max(2, m // 10) * ct[0]
            halo = window_span(m, k, ct[1], ct[2])
            for width in (rj - 1, rj + 1, 2 * rj + warp + 1):
                own = width - halo  # a segment reads `width` columns
                hay = hay0.copy()
                planted = plant_boundary_swaps(
                    hay, needle, [s * own - halo for s in range(1, 7)],
                    bcols)
                hay_d = torch.from_numpy(hay).to(dev)
                kw = dict(own_len=own, halo=halo, costs_t=ct)
                got = sf.flat_search(hay_d, nd, **kw)
                torch.cuda.synchronize()
                err = _search_err(got, sf.flat_search_plain(hay_d, nd, **kw))
                worst = max(worst, err)
                check(planted >= 3 and err == 0,
                      f"flat_search != plain at the launch shape: m={m} "
                      f"costs={c} segment width={width}, {planted} copies "
                      "across boundaries")
                cases += 1
    return cases, worst


def band_entry_pairs(length: int, burst: int, rng, at=None):
    """Pairs whose best path runs along the band's edge: a = X^length
    against b = Y^burst + X^length (the reference's band-entry repro,
    ROADMAP.md Queue 3), and a random ACGT string against copies with a
    burst of exactly `burst` inserted chars at the front and in the
    middle (at byte `at`, by default length // 2)."""
    x = np.full(length, ord("X"), np.uint8)
    a_list = [x, ACGT[rng.integers(0, 4, length)]]
    a_list.append(a_list[1])
    b_list = [np.concatenate([np.full(burst, ord("Y"), np.uint8), x])]
    burst_chars = ACGT[rng.integers(0, 4, burst)]
    b_list.append(np.concatenate([burst_chars, a_list[1]]))
    b_list.append(np.insert(a_list[1], length // 2 if at is None else at,
                            burst_chars))
    return a_list, b_list


def check_flat_distance_kernel(dev):
    """K9 against its plain version on the card, exactly, in both modes
    (the full matrix, and banded at FLAT_DIST_CHECK_UK) under the four cost
    models, on pairs of up to FLAT_DIST_CHECK_LEN bytes (two column strips)
    with NUL bytes and empty strings; then the band-entry pairs at a strip
    boundary, banded at exactly their burst, also against the compiled
    scalar comparator."""
    from triple_accel_tpu_torch.ops import search_flat as sf
    from triple_accel_tpu_torch.types import EditCosts
    from triple_accel_tpu_torch.utils.native import (
        scalar_banded_batch_native)

    rng = np.random.default_rng(9090)
    a_list, b_list = make_long_pairs(FLAT_DIST_CHECK_PAIRS,
                                     FLAT_DIST_CHECK_LEN, 0.004, seed=9091)
    for p in range(FLAT_DIST_CHECK_PAIRS):
        cut = int(rng.integers(1, FLAT_DIST_CHECK_LEN + 1))
        a_list[p], b_list[p] = a_list[p][:cut].copy(), b_list[p][:cut + 20]
        a_list[p][rng.integers(0, cut, 2)] = 0
    a_list[0] = np.empty(0, np.uint8)
    b_list[1] = np.empty(0, np.uint8)
    t = sf.prepare_flat_distance_inputs(a_list, b_list, device=dev)
    cases, worst = 0, 0
    for c in FUZZ_COSTS:
        ct = fuzz_costs_t(c)
        for uk in (None, FLAT_DIST_CHECK_UK):
            got = sf.flat_distance(*t, costs_t=ct, unit_k=uk)
            torch.cuda.synchronize()
            ref = sf.flat_distance_plain(*t, costs_t=ct, unit_k=uk)
            err = int((got.to(torch.int64) - ref.to(torch.int64)).abs().max())
            worst = max(worst, err)
            check(err == 0, f"flat_distance != plain at costs={c} "
                            f"unit_k={uk}")
            cases += 1
    # the launch shape: widths one off a multiple of a warp's columns and
    # of the strip, swaps whose transposition reads across a lane, a warp
    # and a strip boundary (the cell (j, j) of a swap of b[j-2], b[j-1])
    warp = 32 * sf.DIST_COLS
    rj = sf.DIST_MAX_THREADS * sf.DIST_COLS
    bcols = flat_boundary_columns(sf.DIST_MAX_THREADS, sf.DIST_COLS)
    a_s, b_s = [], []
    for ln in (warp - 1, warp + 1, rj - 1, rj + 1, rj + warp + 1):
        for shift in (0, 1):
            a = ACGT[rng.integers(0, 4, ln)]
            b = a.copy()
            swapped = set()
            for col in bcols:
                p = col + shift - 2
                if p + 1 < ln and not {p, p + 1} & swapped:
                    b[p], b[p + 1] = b[p + 1], b[p]
                    swapped |= {p, p + 1}
            a_s.append(a)
            b_s.append(edit_acgt(b, 2, rng) if shift else b)
    t = sf.prepare_flat_distance_inputs(a_s, b_s, device=dev)
    for c in FUZZ_COSTS:
        ct = fuzz_costs_t(c)
        for uk in (None, FLAT_DIST_CHECK_UK):
            got = sf.flat_distance(*t, costs_t=ct, unit_k=uk)
            torch.cuda.synchronize()
            ref = sf.flat_distance_plain(*t, costs_t=ct, unit_k=uk)
            err = int((got.to(torch.int64) - ref.to(torch.int64)).abs().max())
            worst = max(worst, err)
            check(err == 0, f"flat_distance != plain at the launch shape, "
                            f"costs={c} unit_k={uk}")
            cases += 1
    # the band-entry pairs: the burst at the middle, then at a warp
    # boundary inside a strip
    for at in (None, 5 * warp):
        a_e, b_e = band_entry_pairs(BAND_ENTRY_LEN, BAND_ENTRY_UK, rng, at)
        t = sf.prepare_flat_distance_inputs(a_e, b_e, device=dev)
        for c in FUZZ_COSTS:
            ct = fuzz_costs_t(c)
            got = sf.flat_distance(*t, costs_t=ct, unit_k=BAND_ENTRY_UK)
            torch.cuda.synchronize()
            ref = sf.flat_distance_plain(*t, costs_t=ct,
                                         unit_k=BAND_ENTRY_UK)
            err = int((got.to(torch.int64) - ref.to(torch.int64)).abs().max())
            exp = scalar_banded_batch_native(a_e, b_e, U32_MAX, EditCosts(*c))
            check(err == 0 and got.cpu().numpy().tolist() == exp.tolist(),
                  f"flat_distance on the band-entry pairs (burst at {at}) at "
                  f"costs={c}: {got.cpu().numpy().tolist()}, plain "
                  f"{ref.cpu().tolist()}, scalar {exp.tolist()}")
            worst = max(worst, err)
            cases += 1
    return cases, worst


# ---------------------------------------------------------------------------
# phases 4 and 5: the main paths
# ---------------------------------------------------------------------------

def _timed(seconds: dict, name: str, fn):
    """`fn` with the card synchronised before and after each call, its
    wall time added to seconds[name] (a kernel's launch and run, a
    transfer's copy)."""
    def run(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn(*args, **kwargs)
        torch.cuda.synchronize()
        seconds[name] = seconds.get(name, 0.0) + time.perf_counter() - t0
        return res
    return run


def _patched(module, **fns):
    """Set module attributes for the length of a `with` block.  A kernel
    wrapper counts its launches on the module's attribute of its name, so
    a replacement carries the count while it stands in, and hands it back."""
    import contextlib

    @contextlib.contextmanager
    def ctx():
        saved = {n: getattr(module, n) for n in fns}
        for n, fn in fns.items():
            if hasattr(saved[n], "launches"):
                fn.launches = saved[n].launches
            setattr(module, n, fn)
        try:
            yield
        finally:
            for n, fn in saved.items():
                if hasattr(fn, "launches"):
                    fn.launches = getattr(module, n).launches
                setattr(module, n, fn)
    return ctx()


def distance_split(a_list, b_list, out) -> dict:
    """Where the `distance` phase's end-to-end time goes: one more call of
    `levenshtein_k_batch` with K1's host prep (packing the strings, then
    the upload of its tensors) and kernel wrapper timed where the entry
    point calls them, then the fetch of the result and the final
    `np.where` timed on the same arrays.  The entry point is unchanged;
    its result is checked."""
    import triple_accel_tpu_torch as tt
    from triple_accel_tpu_torch.ops import myers_distance as md

    secs, keep = {}, {}
    prep, kernel = md.prepare_myers_inputs, md.myers_distance

    def timed_prep(*args, device, **kwargs):
        host = _timed(secs, "host_prep_s", prep)(*args, device="cpu",
                                                 **kwargs)
        return _timed(secs, "upload_s",
                      lambda: tuple(x.to(device) for x in host))()

    def timed_kernel(*args, **kwargs):
        keep["dist"] = _timed(secs, "kernel_s", kernel)(*args, **kwargs)
        return keep["dist"]

    with _patched(md, prepare_myers_inputs=timed_prep,
                  myers_distance=timed_kernel):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        again = tt.levenshtein_k_batch(a_list, b_list, K_DIST)
        e2e = time.perf_counter() - t0
    check(np.array_equal(again, out), "timed distance rerun != main path")
    t0 = time.perf_counter()
    fetched = keep["dist"].cpu().numpy().astype(np.int64)
    secs["fetch_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    np.where(fetched <= K_DIST, fetched, -1)
    secs["np_where_s"] = time.perf_counter() - t0
    secs["lists_and_dispatch_math_s"] = e2e - sum(secs.values())
    return {"e2e_s": round(e2e, 4),
            **{k_: round(v, 4) for k_, v in secs.items()}}


def search_split(needle, hay, costs, st) -> dict:
    """Where one `search` call's end-to-end time goes: the call again
    with K2's wrapper, the hit collection (`torch.nonzero` and the fetch
    of the hits), the length replay and `_postprocess_sparse` timed where
    the entry point calls them; what precedes the kernel is the haystack's
    upload and the needle's prep."""
    import importlib

    from triple_accel_tpu_torch.ops import myers_search as ms_mod

    lev = importlib.import_module("triple_accel_tpu_torch.levenshtein")
    secs, first = {}, {}
    kernel = _timed(secs, "kernel_s", ms_mod.myers_search)

    def marked_kernel(*args, **kwargs):
        first.setdefault("at", time.perf_counter())
        return kernel(*args, **kwargs)

    with _patched(ms_mod, myers_search=marked_kernel,
                  collect_hits=_timed(secs, "collect_hits_s",
                                      ms_mod.collect_hits)), \
            _patched(lev, _resolve_hits_batch=_timed(
                secs, "replay_s", lev._resolve_hits_batch),
                _resolve_hits_flat=_timed(
                    secs, "replay_s", lev._resolve_hits_flat),
                _postprocess_sparse=_timed(
                    secs, "postprocess_s", lev._postprocess_sparse)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lev.levenshtein_search_simd_with_opts(needle, hay, K_SEARCH, st,
                                              costs, False)
        e2e = time.perf_counter() - t0
    secs["upload_and_needle_prep_s"] = first["at"] - t0
    secs["rest_s"] = e2e - sum(secs.values())
    return {"e2e_s": round(e2e, 4),
            **{k_: round(v, 4) for k_, v in secs.items()}}


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

    split = distance_split(a_list, b_list, out)

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

    bound = prof.k1_bound(margs[2].cpu().numpy(), K_DIST)
    emit({
        "phase": "distance", "pairs": n_pairs, "str_len": STR_LEN,
        "k": K_DIST, "dispatch": "myers", "launches": launches,
        "reference": ref_kind, "oracle_sample": len(sample),
        "datagen_s": round(gen_s, 3), "e2e_s": round(e2e_s, 4),
        "pairs_per_s_e2e": round(n_pairs / e2e_s, 1),
        "host_prep_and_upload_s": round(prep_s, 4),
        "e2e_split_s": split,
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
        "plain_ms": plain_ms, **bound, "library_ms": None,
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

    split = {f"{c}_{st.name}": search_split(needle, hay, costs, st)
             for c, costs in (("unit", LEVENSHTEIN_COSTS),
                              ("rdamerau", RDAMERAU_COSTS))
             for st in (SearchType.Best, SearchType.All)}

    # kernel only, at the tensors the main path gives it
    halo = ms_mod.search_halo(window_span(NEEDLE_LEN, K_SEARCH, 1, 0), n)
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

    bounds = {d: prof.k2_bound(n, NEEDLE_LEN, d) for d in (False, True)}
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
        "e2e_split_s": split,
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
        **bounds[False], "library_ms": None,
        # the restricted-Damerau launches of the same path, same shape
        "ms_rdamerau": kernel_ms[True][0],
        "ms_rdamerau_min": kernel_ms[True][1],
        "ms_rdamerau_max": kernel_ms[True][2],
        "plain_ms_rdamerau": plain_ms[True],
        "bound_ms_rdamerau": bounds[True]["bound_ms"],
        "bound_operations_ms_rdamerau": bounds[True]["bound_operations_ms"],
    }, results, e2e


# ---------------------------------------------------------------------------
# dictionary search and resumable sweeps
# ---------------------------------------------------------------------------

def dictionary_calls(groups):
    """(name, needles, k, search type, costs) of the dictionary phase, in
    order: the short needles under unit and rDamerau costs, Best and All,
    unit All again on the same PackedHaystack, the K6 group and the
    general-cost group."""
    from triple_accel_tpu_torch.types import (
        EditCosts, LEVENSHTEIN_COSTS, RDAMERAU_COSTS, SearchType)

    short = groups["short"]
    return [
        ("unit_Best", short, K_DICT, SearchType.Best, LEVENSHTEIN_COSTS),
        ("unit_All", short, K_DICT, SearchType.All, LEVENSHTEIN_COSTS),
        ("rdamerau_Best", short, K_DICT, SearchType.Best, RDAMERAU_COSTS),
        ("rdamerau_All", short, K_DICT, SearchType.All, RDAMERAU_COSTS),
        ("unit_All_repeat", short, K_DICT, SearchType.All,
         LEVENSHTEIN_COSTS),
        ("long_All", groups["long"], DICT_LONG[2], SearchType.All,
         LEVENSHTEIN_COSTS),
        ("general_All", groups["general"], DICT_GENERAL[2], SearchType.All,
         EditCosts(*DICT_GENERAL_COSTS)),
    ]


def dictionary_plan(needles, n: int, k: int, costs) -> dict:
    """{needle length: needles a launch, in launch order} of one
    dictionary call under unit or rDamerau costs, from the entry point's
    own plan."""
    import importlib

    lev = importlib.import_module("triple_accel_tpu_torch.levenshtein")
    out = {}
    for m in sorted({len(nd) for nd in needles}):
        num = sum(len(nd) == m for nd in needles)
        engine, _, _, halo, own_len = lev._myers_search_plan(m, n, k, costs,
                                                             False)
        out[m] = [hi - lo for lo, hi in lev._many_launch_plan(
            num, n, engine == "myers_search_blocked", halo, own_len)]
    return out


def dictionary_split(groups, hay) -> dict:
    """Where a dictionary's time goes: on a fresh PackedHaystack, unit All
    over the short needles, the K6 group and the general-cost group, with
    the upload, the kernel wrappers, the hit fetch, the length replay and
    `_postprocess_sparse` timed where the entry point calls them."""
    import importlib

    from triple_accel_tpu_torch.ops import myers_chunked as mc
    from triple_accel_tpu_torch.ops import myers_search as ms_mod
    from triple_accel_tpu_torch.ops import search_diag as sd

    lev = importlib.import_module("triple_accel_tpu_torch.levenshtein")
    calls = {c[0]: c for c in dictionary_calls(groups)}
    out = {}
    ph = lev.PackedHaystack(hay)
    for name in ("unit_All", "long_All", "general_All"):
        secs = {}
        _, nds, k, st, costs = calls[name]
        with _patched(lev, _upload_haystack=_timed(
                secs, "upload_s", lev._upload_haystack),
                _resolve_hits_batch=_timed(
                    secs, "replay_s", lev._resolve_hits_batch),
                _resolve_hits_flat=_timed(
                    secs, "replay_s", lev._resolve_hits_flat),
                _postprocess_sparse=_timed(
                    secs, "postprocess_s", lev._postprocess_sparse)), \
                _patched(ms_mod, myers_search=_timed(
                    secs, "k2_s", ms_mod.myers_search),
                    collect_hits=_timed(
                        secs, "hit_fetch_s", ms_mod.collect_hits)), \
                _patched(mc, blocked_search=_timed(
                    secs, "k6_s", mc.blocked_search)), \
                _patched(sd, search_diag=_timed(
                    secs, "k7_s", sd.search_diag)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lev.levenshtein_search_many(nds, ph, k, st, costs)
            e2e = time.perf_counter() - t0
        secs["rest_s"] = e2e - sum(secs.values())
        out[name] = {"e2e_s": round(e2e, 4),
                     **{k_: round(v, 4) for k_, v in secs.items()}}
    return out


def run_dictionary(dev, hay_mb: int, native_loaded: bool):
    """Dictionary search at full size: one PackedHaystack of hay_mb MiB,
    512 short needles in four length groups (K2, a group a launch per
    memory chunk), 4 long ones (K6), 4 under general costs (K7, a needle
    at a time).  Returns the launches of K2, K6 and K7 on this path."""
    import importlib

    from triple_accel_tpu_torch.dispatch import dispatch_history
    from triple_accel_tpu_torch.ops import myers_chunked as mc
    from triple_accel_tpu_torch.ops import myers_search as ms_mod
    from triple_accel_tpu_torch.ops import search_diag as sd
    from triple_accel_tpu_torch.oracle import (
        levenshtein_search_naive_with_opts)
    from triple_accel_tpu_torch.types import (
        LEVENSHTEIN_COSTS, RDAMERAU_COSTS, SearchType)
    from triple_accel_tpu_torch.utils.native import search_all_native

    lev = importlib.import_module("triple_accel_tpu_torch.levenshtein")
    t_phase = t0 = time.perf_counter()
    hay, groups, where = make_dictionary(hay_mb << 20)
    gen_s = time.perf_counter() - t0
    n = len(hay)
    calls = dictionary_calls(groups)
    torch.cuda.synchronize()
    prior_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    base_mb = torch.cuda.memory_allocated() / 2**20

    results, e2e, launches, paths = {}, {}, {}, {}
    ph = lev.PackedHaystack(hay)
    kernels = (ms_mod.myers_search, mc.blocked_search, sd.search_diag)
    for fn in kernels:  # counts start at 0 just before the path
        fn.launches = 0
    for name, nds, k, st, costs in calls:
        before = [fn.launches for fn in kernels]
        dispatch_history(clear=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results[name] = lev.levenshtein_search_many(nds, ph, k, st, costs)
        torch.cuda.synchronize()
        e2e[name] = time.perf_counter() - t0
        launches[name] = [fn.launches - b for fn, b in zip(kernels, before)]
        paths[name] = [d.path for _, d in dispatch_history()]
    total = [fn.launches for fn in kernels]  # and are read just after it
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    check(ph.uploads == 1, f"{ph.uploads} uploads of the PackedHaystack")

    # launches and dispatch names against the entry point's own plan
    plans = {}
    for name, nds, k, st, costs in calls:
        if name == "general_All":
            want, names = [0, 0, len(nds)], {"search_diag"}
        else:
            plans[name] = dictionary_plan(nds, n, k, costs)
            count = sum(len(v) for v in plans[name].values())
            blocked = name == "long_All"
            want = [0, count, 0] if blocked else [count, 0, 0]
            names = {"myers_search_many_blocked" if blocked
                     else "myers_search_many"}
            check(len(paths[name]) == min(count, 64),
                  f"{name}: {len(paths[name])} dispatch entries for "
                  f"{count} launches")
        check(launches[name] == want,
              f"{name}: launches {launches[name]} != the plan's {want}")
        check(set(paths[name]) == names,
              f"{name}: the dictionary took {set(paths[name])}")

    # every planted copy found, Best equal to All's minimum
    for name, g, m_k, st_pair in (
            ("unit", "short", 2, ("unit_Best", "unit_All")),
            ("rdamerau", "short", 2, ("rdamerau_Best", "rdamerau_All")),
            ("long", "long", DICT_LONG[4], (None, "long_All")),
            ("general", "general", 2 * DICT_GENERAL[4],
             (None, "general_All"))):
        all_r = results[st_pair[1]]
        for i, starts in where[g].items():
            nd = groups[g][i]
            by_end = {mt.end: mt for mt in all_r[i]}
            for pos in starts:
                mt = by_end.get(pos + len(nd))
                check(mt is not None and mt.k <= m_k,
                      f"{name}: needle {i}'s copy at {pos} not found "
                      f"with k <= {m_k}")
        if st_pair[0] is None:
            continue
        for i, (best, all_m) in enumerate(zip(results[st_pair[0]], all_r)):
            ends = {mt.end for mt in all_m}
            kmin = min((mt.k for mt in all_m), default=None)
            check(bool(best) == bool(all_m)
                  and all(mt.k == kmin and mt.end in ends for mt in best),
                  f"{name}: Best of needle {i} is not All's minimum")
    check(results["unit_All_repeat"] == results["unit_All"],
          "the repeated call on the same PackedHaystack differs")

    # a sample of each call against the single-needle entry point
    rng = np.random.default_rng(DICT_SEED + 1)
    single_ms = {}
    for name, nds, k, st, costs in calls:
        planted = sorted(where["short"]) if nds is groups["short"] else []
        pick = list(planted[: DICT_SAMPLE // 2])
        rest = sorted(set(range(len(nds))) - set(pick))
        pick += list(rng.choice(rest, min(len(rest), DICT_SAMPLE - len(pick)),
                                replace=False))
        times = []
        for i in pick:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            one = lev.levenshtein_search_simd_with_opts(nds[i], hay, k, st,
                                                        costs, False)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            check(one == results[name][i],
                  f"{name}: needle {i} != its single-needle search")
        single_ms[name] = round(statistics.median(times) * 1e3, 4)

    # All mode over the first MiB against the compiled scalar search (or,
    # without the native library, the Python oracle over 64 KiB)
    prefix = min((1 << 20) if native_loaded else (1 << 16), n)
    sample = [groups["short"][i] for i in sorted(where["short"])
              [:DICT_PREFIX_NEEDLES]]
    for costs in (LEVENSHTEIN_COSTS, RDAMERAU_COSTS):
        got = lev.levenshtein_search_many(sample, hay[:prefix], K_DICT,
                                          SearchType.All, costs)
        for nd, ms in zip(sample, got):
            if native_loaded:
                ends, ks, lens = search_all_native(nd, hay[:prefix], K_DICT,
                                                   costs)
                exp = list(zip((ends - lens).tolist(), ends.tolist(),
                               ks.tolist()))
            else:
                exp = [(mt.start, mt.end, mt.k)
                       for mt in levenshtein_search_naive_with_opts(
                           nd, hay[:prefix], K_DICT, SearchType.All, costs,
                           False)]
            check([(mt.start, mt.end, mt.k) for mt in ms] == exp,
                  "dictionary All mode on the prefix != reference")
            check(len(ms) > 0 or not native_loaded,
                  "a needle planted in the prefix has no match there")

    split = dictionary_split(groups, hay)
    counts = {c[0]: len(c[1]) for c in calls}
    emit({
        "phase": "dictionary", "haystack_bytes": n,
        "needles": {name: counts[name] for name in counts},
        "lengths": list(DICT_LENS), "k": K_DICT,
        "planted_needles": DICT_PLANTED, "copies": DICT_COPIES,
        "long_group": dict(zip(("needles", "len", "k", "copies", "subs"),
                               DICT_LONG)),
        "general_group": dict(zip(("needles", "len", "k", "copies", "subs"),
                                  DICT_GENERAL)),
        "general_costs": list(DICT_GENERAL_COSTS),
        "uploads": ph.uploads,
        "launch_budget_bytes": lev._MANY_LAUNCH_BYTES,
        # launches and the most needles a launch, by needle length
        "chunk_plan": {name: {str(m): [len(v), max(v)]
                              for m, v in plans[name].items()}
                       for name in ("unit_All", "long_All")},
        "launches_k2_k6_k7": {**launches, "total": total},
        "dispatch": {name: sorted(set(v)) for name, v in paths.items()},
        "matches": {name: sum(len(r) for r in res)
                    for name, res in results.items()},
        "reference_prefix_bytes": prefix,
        "datagen_s": round(gen_s, 3),
        "e2e_s": {k_: round(v, 4) for k_, v in e2e.items()},
        "needles_per_s": {k_: round(counts[k_] / v, 1)
                          for k_, v in e2e.items()},
        "needle_GBps": {k_: round(counts[k_] * n / v / 1e9, 3)
                        for k_, v in e2e.items()},
        "single_call_ms_per_needle": single_ms,
        "e2e_split_s": split,
        "peak_device_MB": round(peak_mb),
        "peak_device_MB_at_start": round(base_mb),
        "phase_s": round(time.perf_counter() - t_phase, 1),
    })
    return {"myers_search": total[0], "blocked_search": total[1],
            "search_diag": total[2], "prior_peak": prior_peak,
            "hay": hay, "short": groups["short"],
            "unit_All": results["unit_All"], "unit_All_s": e2e["unit_All"]}


def run_sweep(dev, needle, hay, mono: dict, mono_e2e: dict):
    """The resumable sweep over the search phase's needle and haystack at
    k = K_SEARCH in slabs of SWEEP_SLAB bytes, unit Best and All with a
    checkpoint, against the search phase's monolithic results; then a
    resume from a checkpoint seeded with the first two slabs' matches."""
    import tempfile

    from triple_accel_tpu_torch.sweep import levenshtein_search_sweep
    from triple_accel_tpu_torch.types import LEVENSHTEIN_COSTS, SearchType
    from triple_accel_tpu_torch.utils.checkpoint import SweepCheckpoint

    n = len(hay)
    slab = min(SWEEP_SLAB, max(1 << 16, n // 4))
    e2e = {}
    with tempfile.TemporaryDirectory() as tmp:
        ck = os.path.join(tmp, "sweep.npz")
        for st in (SearchType.Best, SearchType.All):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = levenshtein_search_sweep(needle, hay, K_SEARCH, st,
                                           LEVENSHTEIN_COSTS,
                                           slab_chars=slab,
                                           checkpoint_path=ck)
            torch.cuda.synchronize()
            e2e[st.name] = time.perf_counter() - t0
            check(got == mono[("unit", st)],
                  f"the {st.name} sweep != the monolithic search")
            check(not os.path.exists(ck), "the checkpoint outlived the sweep")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = levenshtein_search_sweep(needle, hay, K_SEARCH, SearchType.All,
                                       LEVENSHTEIN_COSTS, slab_chars=slab)
        torch.cuda.synchronize()
        e2e["All_no_checkpoint"] = time.perf_counter() - t0
        check(got == mono[("unit", SearchType.All)],
              "the All sweep without a checkpoint != the monolithic search")
        full = mono[("unit", SearchType.All)]
        seeded = SweepCheckpoint.load_or_create(ck)
        seeded.advance(2 * slab, [mt for mt in full if mt.end <= 2 * slab])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        resumed = levenshtein_search_sweep(needle, hay, K_SEARCH,
                                           SearchType.All, LEVENSHTEIN_COSTS,
                                           slab_chars=slab,
                                           checkpoint_path=ck)
        torch.cuda.synchronize()
        e2e["All_resumed_after_2_slabs"] = time.perf_counter() - t0
        check(resumed == full, "the resumed sweep != the monolithic search")
        check(not os.path.exists(ck), "the checkpoint outlived the resume")
    mono_s = {st: mono_e2e[f"unit_{st}"] for st in ("Best", "All")}
    emit({"phase": "sweep", "haystack_bytes": n, "needle_len": len(needle),
          "k": K_SEARCH, "slab_chars": slab, "slabs": -(-n // slab),
          "matches": {st.name: len(mono[("unit", st)])
                      for st in (SearchType.Best, SearchType.All)},
          "resumed_from_offset": 2 * slab,
          "e2e_s": {k_: round(v, 4) for k_, v in e2e.items()},
          "monolithic_e2e_s": {k_: round(v, 4) for k_, v in mono_s.items()},
          "sweep_over_monolithic": {
              st: round(e2e[st] / mono_s[st], 3) for st in mono_s}})


# ---------------------------------------------------------------------------
# the mesh routes
# ---------------------------------------------------------------------------

MESH_SHARDS = 4  # shards of the one-card mesh: the ring's overhead
MESH_BAND_PAIRS = 1 << 14  # the band engine's cut of the distance pairs
MESH_PREFIX = 1 << 24  # the long-needle calls' haystack prefix
MESH_K6_LEN, MESH_K6_K = 3000, 150
MESH_K8_LEN, MESH_K8_K = 600, 30
MESH_PLANT_OFFSETS = (-2, -1, 0, 1, 2)


def mesh_kernels():
    """{name: wrapper} of every kernel a mesh route can launch."""
    from triple_accel_tpu_torch.ops import lev_band as lb
    from triple_accel_tpu_torch.ops import myers_chunked as mc
    from triple_accel_tpu_torch.ops import myers_distance as md
    from triple_accel_tpu_torch.ops import myers_search as ms_mod
    from triple_accel_tpu_torch.ops import search_diag as sd
    from triple_accel_tpu_torch.ops import search_flat as sf

    return {"myers_distance": md.myers_distance,
            "myers_search": ms_mod.myers_search,
            "band_distance": lb.band_distance,
            "blocked_distance": mc.blocked_distance,
            "blocked_search": mc.blocked_search,
            "search_diag": sd.search_diag, "flat_search": sf.flat_search,
            "flat_distance": sf.flat_distance}


def mesh_plant(hay, needle, bounds, off: int):
    """Copies of the needle ending `off` bytes past each inner shard edge
    (the owner-by-end rule's edge cases), written into `hay`; returns the
    bytes they replaced and their end positions."""
    m = len(needle)
    saved, ends = [], []
    for lo, _ in bounds[1:]:
        end = lo + off
        saved.append((end - m, hay[end - m:end].copy()))
        hay[end - m:end] = needle
        ends.append(end)
    return saved, ends


def run_mesh(dev, a_list, b_list, k1_out, needle, hay, mono, dct, pairs5,
             pairs9):
    """Every `mesh=` route at the full width of the phases before it (and
    of the `blocked_distance` and `flat_distance` phases' inputs, `pairs5`
    and `pairs9`), on `make_mesh()` (every visible card) and on
    MESH_SHARDS shards of one card, each against the meshless call (and
    the earlier phases' results), with the seconds of each call, warm,
    and each kernel's launches by mesh.  Returns {kernel: {mesh:
    launches}}."""
    import importlib
    import tempfile

    import triple_accel_tpu_torch as tt
    from triple_accel_tpu_torch.dispatch import dispatch_history
    from triple_accel_tpu_torch.parallel import (
        make_mesh, match_count_psum, shard_bounds)
    from triple_accel_tpu_torch.sweep import levenshtein_search_sweep
    from triple_accel_tpu_torch.types import (
        EditCosts, LEVENSHTEIN_COSTS, RDAMERAU_COSTS, SearchType)

    lev = importlib.import_module("triple_accel_tpu_torch.levenshtein")
    ham = importlib.import_module("triple_accel_tpu_torch.hamming")
    t_phase = time.perf_counter()
    meshes = {f"cards_{torch.cuda.device_count()}": make_mesh(),
              f"shards_{MESH_SHARDS}_on_one_card":
                  make_mesh([dev] * MESH_SHARDS)}
    kernels = mesh_kernels()
    launches = {name: {key: 0 for key in meshes} for name in kernels}
    seconds, first_s, paths = {}, {}, {}

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def same(got, ref) -> bool:
        return (got == ref if isinstance(ref, list)
                else np.array_equal(got, ref))

    def drive(item, call, ref, meshless=False, on=None):
        """`call(None)` (with `meshless`), then `call(mesh)` on each mesh
        (or on the one named `on`), each equal to `ref` (None: to the
        meshless call's result), every kernel a mesh call launches at
        least once a shard, its launches counted from 0 just before it and
        read just after it.  Then every route again in the reverse order:
        those warm seconds are the ones kept (the first calls' go under
        `seconds_first`)."""
        routes = ([("meshless", None)] if meshless else []) + [
            (key, mesh) for key, mesh in meshes.items() if on in (None, key)]
        first, warm = {}, {}
        for key, mesh in routes:
            for fn in kernels.values():
                fn.launches = 0
            dispatch_history(clear=True)
            got, first[key] = timed(lambda: call(mesh))
            counts = {n: fn.launches for n, fn in kernels.items()}
            ref = got if ref is None else ref
            check(same(got, ref),
                  f"mesh phase {item} on {key} != the meshless call")
            if mesh is None:
                continue
            ran = {n: c for n, c in counts.items() if c}
            check(ran and all(c >= mesh.size for c in ran.values()),
                  f"mesh phase {item} on {key}: launches {ran}, not at "
                  f"least one a shard")
            for n, c in counts.items():
                launches[n][key] += c
            paths.setdefault(item, {})[key] = {
                "dispatch": sorted({d.path for _, d in dispatch_history()}),
                "launches": ran}
        for key, mesh in reversed(routes):
            got, warm[key] = timed(lambda: call(mesh))
            check(same(got, ref), f"mesh phase {item} on {key}, called "
                                  "again, != the meshless call")
        seconds[item] = {k_: round(warm[k_], 4) for k_, _ in routes}
        first_s[item] = {k_: round(first[k_], 4) for k_, _ in routes}

    # K1: the distance phase's pairs, against its result
    drive("distance_k1", lambda mesh: tt.levenshtein_k_batch(
        a_list, b_list, K_DIST, mesh=mesh), k1_out, meshless=True)
    # K3: a cut of the same pairs under rDamerau costs
    a3, b3 = a_list[:MESH_BAND_PAIRS], b_list[:MESH_BAND_PAIRS]
    drive("band_k3", lambda mesh: tt.levenshtein_k_batch(
        a3, b3, K_DIST, RDAMERAU_COSTS, mesh=mesh), None, meshless=True)
    # K5 and K9: the blocked_distance and flat_distance phases' inputs
    # (unit costs; affine), at an unbounded threshold
    a5, b5 = pairs5
    drive("blocked_k5", lambda mesh: tt.levenshtein_k_batch(
        a5, b5, U32_MAX, mesh=mesh), None, meshless=True)
    a9, b9 = pairs9
    drive("flat_k9", lambda mesh: tt.levenshtein_k_batch(
        a9, b9, U32_MAX, EditCosts(*AFFINE), mesh=mesh), None,
        meshless=True)
    # the global count of distances <= k, summed over the shards of a
    # batch that lies on the card
    k1_d = torch.from_numpy(np.asarray(k1_out)).to(dev)
    want = int((k1_d <= K_DIST).sum())
    psum = {key: match_count_psum(mesh, k1_d, K_DIST)
            for key, mesh in meshes.items()}
    check(all(v == want for v in psum.values()),
          f"match_count_psum {psum} != {want}")

    # K2: the search phase's four calls, against its results
    def search(costs, st, h=hay, nd=needle, k=K_SEARCH):
        return lambda mesh: (
            lev.levenshtein_search_simd_with_opts(nd, h, k, st, costs, False)
            if mesh is None else
            lev.levenshtein_search_sharded(nd, h, k, mesh, st, costs))

    for cname, costs in (("unit", LEVENSHTEIN_COSTS),
                         ("rdamerau", RDAMERAU_COSTS)):
        for st in (SearchType.Best, SearchType.All):
            drive(f"search_k2_{cname}_{st.name}", search(costs, st),
                  mono[(cname, st)], meshless=True)
    # copies of the needle ending on and around the inner shard edges of
    # the one-card mesh, each found once at cost 0
    bounds = shard_bounds(len(hay), MESH_SHARDS)
    for off in MESH_PLANT_OFFSETS:
        saved, ends = mesh_plant(hay, needle, bounds, off)
        try:
            ref = lev.levenshtein_search_simd_with_opts(
                needle, hay, K_SEARCH, SearchType.All, LEVENSHTEIN_COSTS,
                False)
            by_end = {mt.end: mt for mt in ref}
            check(all(e in by_end and by_end[e].k == 0 for e in ends),
                  f"a copy ending at a shard edge {off:+d} was not found")
            drive(f"edge_copies_{off:+d}", search(LEVENSHTEIN_COSTS,
                                                  SearchType.All), ref)
        finally:
            for start, old in saved:
                hay[start:start + len(old)] = old
    # K7: a general-cost call; K6 and K8: long needles over a prefix
    gen = EditCosts(*GENERAL_COSTS[0])
    drive("search_k7", search(gen, SearchType.All, k=K_GENERAL),
          lev.levenshtein_search_simd_with_opts(
              needle, hay, K_GENERAL, SearchType.All, gen, False),
          meshless=True)
    prefix = hay[:MESH_PREFIX]
    for item, m, k, costs in (("search_k6", MESH_K6_LEN, MESH_K6_K,
                               LEVENSHTEIN_COSTS),
                              ("search_k8", MESH_K8_LEN, MESH_K8_K, gen)):
        nd = prefix[len(prefix) // 3:len(prefix) // 3 + m].copy()
        nd[::97] = ACGT[0]  # a few edits against its source
        drive(item, search(costs, SearchType.All, h=prefix, nd=nd, k=k),
              lev.levenshtein_search_simd_with_opts(
                  nd, prefix, k, SearchType.All, costs, False),
              meshless=True)

    # the dictionary: its 512 short needles on one PackedHaystack, twice
    # a mesh (the first call packs it, the second uploads nothing)
    ph = lev.PackedHaystack(dct["hay"])
    uploads = {}
    for key, mesh in meshes.items():
        before = ph.uploads
        drive(f"dictionary_{key}", lambda mesh: lev.levenshtein_search_many(
            dct["short"], ph, K_DICT, SearchType.All, LEVENSHTEIN_COSTS,
            mesh=mesh), dct["unit_All"], on=key)
        uploads[key] = ph.uploads - before
        check(uploads[key] == mesh.size,
              f"the sharded dictionary on {key} uploaded {uploads[key]} "
              f"times, not once a shard")
    seconds["dictionary_meshless"] = {"meshless": round(dct["unit_All_s"],
                                                        4)}

    # Hamming (plain ops: no kernel counted), each call timed warm
    a2, b2 = np.stack(a_list), np.stack(b_list)
    hsecs = {}

    def warm_timed(name, fn, ref=None):
        got = fn()
        check(ref is None or same(got, ref), f"hamming {name}")
        got, hsecs[name] = timed(fn)
        check(ref is None or same(got, ref), f"hamming {name}, again")
        return got

    ref_h = warm_timed("batch_meshless", lambda: ham.hamming_batch(a2, b2),
                       (a2 != b2).sum(axis=1))
    refs = {st: warm_timed(f"search_{st.name}_meshless",
                           lambda st=st: ham.hamming_search_simd_with_opts(
                               needle, hay, HAMMING_K, st))
            for st in (SearchType.Best, SearchType.All)}
    check(all(refs.values()), "the Hamming search found nothing")
    for key, mesh in meshes.items():
        warm_timed(f"batch_{key}",
                   lambda: ham.hamming_batch(a2, b2, mesh=mesh), ref_h)
        for st in (SearchType.Best, SearchType.All):
            warm_timed(f"search_{st.name}_{key}",
                       lambda st=st: ham.hamming_search_sharded(
                           needle, hay, HAMMING_K, mesh, st), refs[st])
    seconds["hamming"] = {k_: round(v, 4) for k_, v in hsecs.items()}

    # the sweep in 4 slabs, each slab sharded
    slab = min(SWEEP_SLAB, max(1 << 16, len(hay) // 4))
    with tempfile.TemporaryDirectory() as tmp:
        for st in (SearchType.Best, SearchType.All):
            ck = os.path.join(tmp, f"mesh_{st.name}.npz")
            drive(f"sweep_{st.name}", lambda mesh, st=st, ck=ck:
                  levenshtein_search_sweep(needle, hay, K_SEARCH, st,
                                           LEVENSHTEIN_COSTS,
                                           slab_chars=slab,
                                           checkpoint_path=ck, mesh=mesh),
                  mono[("unit", st)])
    emit({"phase": "mesh", "card": smi_line(),
          "meshes": {k_: m_.size for k_, m_ in meshes.items()},
          "note": f"{MESH_SHARDS} shards on one card measure the halo "
                  "ring's and the per-shard launches' overhead, not "
                  "scaling; `seconds` are each route's second call, the "
                  "routes in the reverse order of the first calls",
          "seconds": seconds, "seconds_first": first_s,
          "dispatch_and_launches": paths, "dictionary_uploads": uploads,
          "match_count_psum": psum,
          "launches": {n: v for n, v in launches.items()
                       if any(v.values())},
          "phase_s": round(time.perf_counter() - t_phase, 1)})
    return launches


# ---------------------------------------------------------------------------
# the band phases: general costs, long strings, tracebacks
# ---------------------------------------------------------------------------

def k10_alone(codes, t, runs, counts, unit_k: int, reps: int) -> dict:
    """K10 on the pair of (runs, counts) (its output on the batch) with the
    longest walk, alone: one group, one chain of dependent steps.  The
    median of `reps` launches (CUDA events around the wrapper: the kernel
    and the gather of one pair's runs) with L2 warm (the pair's codes read
    by the launch before), and of `reps` launches each after a write of
    K10_FLUSH_BYTES that empties L2, so that its codes come from device
    memory as the batch's do; each series after a warm-up."""
    from triple_accel_tpu_torch.ops import trace_walk as tw

    lengths = prof.walk_lengths(runs, counts)
    p = int(lengths.argmax())
    one = [x[p:p + 1] for x in (codes, *t)]
    flush = torch.empty(K10_FLUSH_BYTES, dtype=torch.uint8,
                        device=codes.device)
    out = {}
    for kind, cold in (("warm", False), ("cold", True)):
        times = []
        for _ in range(reps + 1):
            if cold:
                flush.fill_(1)
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            got, _ = tw.trace_walk(*one, unit_k=unit_k)
            t1.record()
            torch.cuda.synchronize()
            times.append(t0.elapsed_time(t1))
        check(torch.equal(got, pair_runs(runs, counts, p)),
              "K10 on one pair != its runs in the batch")
        ms = statistics.median(times[1:])
        key = "longest_walk_alone_ms" + ("" if cold else "_warm")
        out[key] = ms
        out[key.replace("_ms", "_ns_a_step")] = ms * 1e6 / int(lengths[p])
    return out


def band_kernel_only(dev, a_list, b_list, decision, costs, traced: bool,
                     out: np.ndarray, reps: int, plain_pairs=None,
                     walk_reps: int = 9):
    """The band kernel alone at the tensors the main path gave it (batch,
    rows and band of the logged dispatch decision): equal to the main
    path's distances, timed, held against the plain version (on the first
    `plain_pairs` pairs where given, else on all); traced, the walk kernel
    K10 over its codes is timed and held against the plain walk on the
    first PLAIN_WALK_PAIRS pairs, and the fetch and decode are timed.
    Returns the numbers of the kernel's entry in the `kernels` line, of
    the phase line, and (traced) of K10's entry."""
    from triple_accel_tpu_torch.ops import band_scan as bs
    from triple_accel_tpu_torch.ops import lev_band as lb
    from triple_accel_tpu_torch.ops import trace_walk as tw

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
    n_plain = len(a_list) if plain_pairs is None else plain_pairs
    tc = tuple(x[:n_plain] for x in t)
    ref = None

    def run_plain():
        nonlocal ref
        ref = bs.band_scan_distance(*tc, trace_on=traced, **kw)

    plain_ms = time_once_ms(run_plain)
    err = band_errors(got_d[:n_plain],
                      None if got_codes is None else got_codes[:n_plain],
                      ref[0], ref[1], tc, unit_k, False)
    check(err == 0, "band kernel != plain at the main-path shape")
    walk = None
    if traced:
        runs, counts = tw.trace_walk(got_codes, *t, unit_k=unit_k)
        steps = tw.walk_steps(t[0].shape[1], unit_k)
        walk_times = time_launches(
            lambda: tw.trace_walk(got_codes, *t, unit_k=unit_k), walk_reps)
        n_walk = min(PLAIN_WALK_PAIRS, len(a_list))
        ref = None

        def run_walk():
            nonlocal ref
            ref = tw.trace_walk_plain(
                got_codes[:n_walk], *(x[:n_walk] for x in t), unit_k=unit_k)

        plain_walk_ms = time_once_ms(run_walk)
        walk_err = runs_err((runs[:int(counts[:n_walk].sum())],
                             counts[:n_walk]), ref)
        check(walk_err == 0, "trace_walk != the plain walk at the main-path "
                             "shape")
        t0 = time.perf_counter()
        runs_np, counts_np = runs.cpu().numpy(), counts.cpu().numpy()
        extra["walk_fetch_s"] = round(time.perf_counter() - t0, 4)
        extra["walk_fetch_MB"] = round(
            (runs_np.nbytes + counts_np.nbytes) / 1e6, 3)
        t0 = time.perf_counter()
        bs.decode_walked_batch(runs_np, counts_np, [False] * len(a_list))
        extra["decode_s"] = round(time.perf_counter() - t0, 4)
        extra["code_MB"] = round(got_codes.numel() * 4 / 1e6, 1)
        extra["walk_ms"] = round(walk_times[0], 4)
        extra["walk_ms_min_max"] = [round(walk_times[1], 4),
                                    round(walk_times[2], 4)]
        extra["walk_runs"] = runs.numel()
        extra["plain_walk_ms"] = round(plain_walk_ms, 1)
        extra["plain_walk_cut_pairs"] = n_walk
        walk = {
            "max_abs_err": walk_err, "ms": walk_times[0],
            "ms_min": walk_times[1], "ms_max": walk_times[2],
            "plain_ms": plain_walk_ms,
            "plain_shape": f"the first {n_walk} pairs (steps as at the "
                           "full batch)",
            "library_ms": None, **prof.k10_bound(runs, counts, steps),
            **k10_alone(got_codes, t, runs, counts, unit_k, walk_reps),
        }
    m_arr = t[2].cpu().numpy().astype(np.int64)
    n_arr = t[3].cpu().numpy().astype(np.int64)
    bound = (prof.k4_bound if traced else prof.k3_bound)(m_arr, n_arr,
                                                     unit_k, ct)
    plan = lb.band_plan(rows, unit_k, traced, batch=len(a_list),
                        max_n=int(n_arr.max(initial=0)))
    tr = str(traced).lower()
    kernel = {"warp": f"band_kernel<*, {tr}, {plan['cells_per_lane']}>",
              "wide_cluster": "band_cluster_kernel<*>",
              "wide": f"band_block_kernel<*, {tr}, {plan['cells_per_lane']}>"}
    entry = {
        "kernel": kernel[plan["regime"]],
        "max_abs_err": err, "ms": times[0], "ms_min": times[1],
        "ms_max": times[2], "plain_ms": plain_ms, "library_ms": None,
        **{k_: bound[k_] for k_ in ("bound_ms", "bound_by", "bound_bytes_ms",
                                    "bound_operations_ms")},
    }
    if n_plain < len(a_list):
        entry["plain_shape"] = f"the first {n_plain} pairs"
    phase = {
        "unit_k": unit_k, "band_cells": 2 * unit_k + 1, "rows": rows,
        "band_regime": plan["regime"],
        **{k_: plan[k_] for k_ in ("cells_per_lane", "lanes_per_pair",
                                   "warps_per_pair", "threads",
                                   "ctas_per_pair") if k_ in plan},
        "host_prep_and_upload_s": round(prep_s, 4),
        "kernel_ms": round(times[0], 4),
        "kernel_ms_min_max": [round(times[1], 4), round(times[2], 4)],
        "plain_ms": round(plain_ms, 1), "plain_cut_pairs": n_plain,
        "Gcells_per_s_kernel": round(bound["cells"] / times[0] / 1e6, 2),
        **extra,
    }
    return entry, phase, walk


def band_entry(name: str, regime: str, traced: bool, replaces: str,
               launches: int, numbers: dict) -> dict:
    return {
        "name": name, "route": "cuda",
        "source": "triple_accel_tpu_torch/csrc/band_distance.cu",
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


def run_band_distance(dev, a_list, b_swapped, k1_pairs, k1_out,
                      native_loaded: bool, scale: float):
    """General-cost distances without traceback, short and long regime."""
    import triple_accel_tpu_torch as tt
    from triple_accel_tpu_torch.ops import lev_band as lb
    from triple_accel_tpu_torch.ops import myers_distance as md
    from triple_accel_tpu_torch.utils.native import (
        scalar_banded_batch_native)

    # short regime: the distance phase's pairs, adjacent swaps added
    n_pairs = len(a_list)
    out, e2e_s, launches, dec = drive_untraced(
        a_list, b_swapped, K_DIST, tt.RDAMERAU_COSTS, "band_distance")
    n_oracle = oracle_sample(a_list, b_swapped, K_DIST, tt.RDAMERAU_COSTS,
                             out, None, 64, "band_distance")
    plain_lev = tt.levenshtein_k_batch(a_list[:4096], b_swapped[:4096],
                                       K_DIST)
    check(bool((out[:4096] <= plain_lev).all())
          and bool((out[:4096] < plain_lev).any()),
          "transpositions never made a pair cheaper than unit costs")
    numbers, phase, _ = band_kernel_only(dev, a_list, b_swapped, dec,
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
    out, e2e_s, launches, dec = drive_untraced(la_list, lb_list, K_LONG,
                                               affine, "band_distance (long)")
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
    numbers, phase, _ = band_kernel_only(dev, la_list, lb_list, dec,
                                         affine, False, out, 7)
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


def band_trace_split(a_list, b_list, k: int, costs, out, traces) -> dict:
    """Where a traced call's end-to-end time goes: the call again with the
    band kernels' host prep (packing the strings, then the upload of their
    tensors), K4 and K10 and the decode of the runs timed where the entry
    point calls them, then the fetch of the distances and the runs timed on
    the same tensors (`fetched_MB`: what crosses to the host); the rest is
    the entry point's list work, dispatch math and its own fetch.  The
    entry point is unchanged; its result is checked."""
    import triple_accel_tpu_torch as tt
    from triple_accel_tpu_torch.ops import band_scan as bs
    from triple_accel_tpu_torch.ops import lev_band as lb
    from triple_accel_tpu_torch.ops import trace_walk as tw

    secs, keep = {}, []
    prep, k4, k10 = lb.prepare_band_tensors, lb.band_trace, tw.trace_walk

    def timed_prep(*args, device, **kwargs):
        host = _timed(secs, "host_prep_s", prep)(*args, device="cpu",
                                                 **kwargs)
        return _timed(secs, "upload_s",
                      lambda: tuple(x.to(device) for x in host))()

    def timed_k4(*args, **kwargs):
        res = _timed(secs, "k4_s", k4)(*args, **kwargs)
        keep.append(res[0])
        return res

    def timed_k10(*args, **kwargs):
        res = _timed(secs, "k10_s", k10)(*args, **kwargs)
        keep.extend(res)
        return res

    with _patched(lb, prepare_band_tensors=timed_prep, band_trace=timed_k4), \
            _patched(tw, trace_walk=timed_k10), \
            _patched(bs, decode_walked_batch=_timed(
                secs, "decode_s", bs.decode_walked_batch)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        again = tt.levenshtein_k_batch(a_list, b_list, k, costs,
                                       trace_on=True)
        e2e = time.perf_counter() - t0
    check(np.array_equal(again[0], out) and again[1] == traces,
          "timed traced rerun != main path")
    t0 = time.perf_counter()
    fetched = sum(x.cpu().numpy().nbytes for x in keep)
    secs["fetch_s"] = time.perf_counter() - t0
    secs["lists_and_rest_s"] = e2e - sum(secs.values())
    return {"e2e_s": round(e2e, 4),
            **{k_: round(v, 4) for k_, v in secs.items()},
            "fetched_MB": round(fetched / 1e6, 3)}


def drive_traced(a_l, b_l, k: int, costs, name: str, path: str):
    """One traced call of `levenshtein_k_batch` with the launch counts of
    K4 and K10 set to 0 just before it and read just after: (distances,
    traces, e2e seconds, K4 launches, K10 launches, the dispatch decision).
    Checks the route, the counts and that every pair came back with a
    distance and a trace that replays a into b at that distance."""
    import triple_accel_tpu_torch as tt
    from triple_accel_tpu_torch.dispatch import dispatch_history
    from triple_accel_tpu_torch.ops import lev_band as lb
    from triple_accel_tpu_torch.ops import trace_walk as tw

    dispatch_history(clear=True)
    lb.band_trace.launches = tw.trace_walk.launches = 0  # 0 just before
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, traces = tt.levenshtein_k_batch(a_l, b_l, k, costs, trace_on=True)
    torch.cuda.synchronize()
    e2e_s = time.perf_counter() - t0
    k4_n, k10_n = lb.band_trace.launches, tw.trace_walk.launches  # after
    hist = dispatch_history()
    check(k4_n >= 1 and k10_n == k4_n,
          f"{name}: {k4_n} band_trace and {k10_n} trace_walk launches")
    check({d.path for _, d in hist} == {path},
          f"{name}: dispatch took {[d.path for _, d in hist]}")
    check(len(traces) == len(a_l) and bool((out >= 0).all()),
          f"{name}: a pair came back without a distance")
    for p in range(len(a_l)):
        check(replay_cost(a_l[p], b_l[p], traces[p], costs) == int(out[p]),
              f"{name}: pair {p}: the trace does not replay a into b at "
              f"cost {int(out[p])}")
    return out, traces, e2e_s, k4_n, k10_n, hist[-1][1]


def walk_entry(name: str, launches: int, numbers: dict) -> dict:
    return {
        "name": name, "route": "cuda",
        "source": "triple_accel_tpu_torch/csrc/trace_walk.cu",
        "kernel": "trace_walk_kernel",
        "replaces": "triple_accel_tpu/ops/band_scan.py:189 (_walk_scan, "
                    "XLA: no pallas_call)",
        "launches": launches, **numbers,
    }


def run_band_trace(dev, a_list, b_swapped, scale: float):
    """Distances with tracebacks: the traced kernel, the walk kernel, the
    decode."""
    import triple_accel_tpu_torch as tt

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
        t0 = time.perf_counter()
        out, traces, e2e_s, launches, walks, dec = drive_traced(
            a_l, b_l, k, tt.RDAMERAU_COSTS, name, "band_trace")
        replay_s = time.perf_counter() - t0 - e2e_s
        n_oracle = oracle_sample(a_l, b_l, k, tt.RDAMERAU_COSTS, out, traces,
                                 32, name)
        split = band_trace_split(a_l, b_l, k, tt.RDAMERAU_COSTS, out, traces)
        numbers, phase, walk = band_kernel_only(
            dev, a_l, b_l, dec, tt.RDAMERAU_COSTS, True, out, 9)
        entries.append(band_entry(name, regime, True, replaces, launches,
                                  numbers))
        entries.append(walk_entry(name.replace("band_trace", "trace_walk"),
                                  walks, walk))
        emit({"phase": "band_trace", "regime": regime, "pairs": len(a_l),
              "str_len": len(a_l[0]), "k": k, "costs": "RDAMERAU_COSTS",
              "dispatch": dec.path, "launches": launches,
              "walk_launches": walks,
              "traces_replayed": len(a_l), "replay_check_s": round(
                  replay_s, 2),
              "oracle_trace_sample": n_oracle,
              "edit_runs_per_pair": round(
                  sum(len(t_) for t_ in traces) / len(traces), 1),
              "e2e_s": round(e2e_s, 4),
              "pairs_per_s_e2e": round(len(a_l) / e2e_s, 1),
              "pairs_per_s_kernel": round(
                  len(a_l) / (numbers["ms"] * 1e-3), 1),
              "e2e_split_s": split, **phase})
    return entries


def run_band_trace_past_plan(dev, scale: float, native_loaded: bool):
    """Traced distances past the band plan (the JAX package's
    `trace_batch` engine): K4's cluster regime (one pair a cluster, the
    plan printed), then K10, on long ACGT pairs at an unbounded threshold
    (unit_k the longest b rounded up to 16); the distances equal the
    untraced call's (K5) and every trace replays.  Then one pair through
    `levenshtein_simd_k_with_opts` and one through
    `levenshtein_exp_with_opts`, whose last rung passes the plan."""
    import importlib

    import triple_accel_tpu_torch as tt
    from triple_accel_tpu_torch.dispatch import dispatch_history
    from triple_accel_tpu_torch.ops import lev_band as lb
    from triple_accel_tpu_torch.ops import myers_chunked as mc
    from triple_accel_tpu_torch.ops import trace_walk as tw
    from triple_accel_tpu_torch.utils.native import (
        scalar_banded_batch_native)

    lev = importlib.import_module("triple_accel_tpu_torch.levenshtein")
    n_pairs = max(8, int(PAST_PLAN_PAIRS * scale))
    t_phase = t0 = time.perf_counter()
    a_list, b_list = make_long_pairs(n_pairs, PAST_PLAN_LEN,
                                     PAST_PLAN_EDIT_SHARE, seed=3030)
    b_list = swap_adjacent_list(b_list, PAST_PLAN_SWAP_SHARE,
                                np.random.default_rng(3031))
    gen_s = time.perf_counter() - t0
    costs, name = tt.RDAMERAU_COSTS, "band_trace (past_plan)"
    t0 = time.perf_counter()
    out, traces, e2e_s, launches, walks, dec = drive_traced(
        a_list, b_list, U32_MAX, costs, name, "band_trace_global")
    replay_s = time.perf_counter() - t0 - e2e_s
    check(dec.unit_k > lb.MAX_UNIT_K, f"{name} ran at unit_k={dec.unit_k}")
    longest_b = max(max(len(a), len(b)) for a, b in zip(a_list, b_list))
    plan = lb.band_plan(dec.padded_m, dec.unit_k, True, batch=n_pairs,
                        max_n=longest_b)
    check(plan["regime"] == "wide_cluster" and dec.unit_k == -(-longest_b
                                                               // 16) * 16,
          f"{name}: plan {plan} at unit_k={dec.unit_k}")
    # the same pairs untraced: the blocked Myers distance kernel (K5)
    dispatch_history(clear=True)
    mc.blocked_distance.launches = 0
    untraced = tt.levenshtein_k_batch(a_list, b_list, U32_MAX, costs)
    check(mc.blocked_distance.launches >= 1
          and {d.path for _, d in dispatch_history()}
          == {"myers_blocked_distance"},
          f"{name}: the untraced call did not take K5")
    check(np.array_equal(untraced, out),
          f"{name}: traced distances != the untraced call's (K5)")
    ref_kind = "K5 on every pair"
    if native_loaded:
        ref = scalar_banded_batch_native(a_list[:1], b_list[:1],
                                         int(out[0]), costs)
        check(int(ref[0]) == int(out[0]),
              f"{name}: pair 0 != the compiled scalar comparator")
        ref_kind += ", ta_scalar_banded_batch on pair 0"
    # one pair through the single-pair entry point
    lb.band_trace.launches = tw.trace_walk.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    single = lev.levenshtein_simd_k_with_opts(a_list[0], b_list[0], U32_MAX,
                                              True, costs)
    torch.cuda.synchronize()
    single_s = time.perf_counter() - t0
    check(lb.band_trace.launches == 1 and tw.trace_walk.launches == 1,
          f"{name}: the single-pair call launched {lb.band_trace.launches} "
          f"band_trace and {tw.trace_walk.launches} trace_walk")
    check(single == (int(out[0]), traces[0]),
          f"{name}: the single-pair call != the batch's pair 0")
    # the exponential search on a pair with nothing in common: its rungs
    # double k from 30 until the last one (k 7,680: unit_k 4,704, band
    # 9,409) passes the shared-memory plan
    x, y = longest_walk_pair(0, 4700)
    dispatch_history(clear=True)
    got = lev.levenshtein_exp_with_opts(x, y, True, costs)
    exp_paths = [d.path for _, d in dispatch_history()]
    check(got == (4700, [tt.Edit(tt.EditType.Mismatch, 4700)])
          and exp_paths[-1] == "band_trace_global"
          and "band_trace_global" not in exp_paths[:-1],
          f"{name}: levenshtein_exp_with_opts gave {str(got)[:80]} over "
          f"{exp_paths}")
    split = band_trace_split(a_list, b_list, U32_MAX, costs, out, traces)
    # kernel only, at the tensors the main path gives it (m <= n)
    sa, sb = shorter_first(a_list, b_list)
    numbers, phase, walk = band_kernel_only(
        dev, sa, sb, dec, costs, True, out, 3,
        plain_pairs=PAST_PLAN_PLAIN_PAIRS, walk_reps=5)
    emit({"phase": "band_trace", "regime": "past_plan", "pairs": n_pairs,
          "str_len": PAST_PLAN_LEN, "edit_share": PAST_PLAN_EDIT_SHARE,
          "swap_share": PAST_PLAN_SWAP_SHARE, "k": U32_MAX,
          "costs": "RDAMERAU_COSTS", "dispatch": dec.path,
          "launches": launches, "walk_launches": walks,
          "reference": ref_kind, "traces_replayed": n_pairs,
          "replay_check_s": round(replay_s, 2),
          "datagen_s": round(gen_s, 3),
          "scratch_MB": round(n_pairs * plan["scratch_bytes_per_pair"] / 1e6,
                              1),
          "e2e_s": round(e2e_s, 4),
          "pairs_per_s_e2e": round(n_pairs / e2e_s, 2),
          "pairs_per_s_kernel": round(n_pairs / (numbers["ms"] * 1e-3), 2),
          "single_pair_e2e_s": round(single_s, 4),
          "exp_with_opts_rungs": exp_paths,
          "e2e_split_s": split, **phase,
          "phase_s": round(time.perf_counter() - t_phase, 1)})
    return [band_entry("band_trace_past_plan", "past_plan", True, "773",
                       launches, dict(numbers, jax_engine=(
                           "triple_accel_tpu/ops/band_scan.py:233 "
                           "band_trace_batch (XLA scan past W 2048)"))),
            walk_entry("trace_walk_past_plan", walks, walk)]


def native_beside(pool, fn, a_l, b_l, *args, parts: int = 6):
    """A compiled comparator `fn(a, b, *args)` over the pairs, in `parts`
    slices on the threads of `pool` (the library releases the GIL), so it
    runs beside the card's work (not beside a timed end-to-end call: its
    packing holds the GIL); returns a function that joins the slices (None
    where the library is missing)."""
    step = max(1, -(-len(a_l) // parts))
    futs = [pool.submit(fn, a_l[i:i + step], b_l[i:i + step], *args)
            for i in range(0, len(a_l), step)]

    def join():
        got = [f.result() for f in futs]
        return None if any(g is None for g in got) else np.concatenate(got)

    return join


def shorter_first(a_l, b_l):
    """The pairs as the entry points hand them to the kernel: m <= n."""
    return ([a if len(a) <= len(b) else b for a, b in zip(a_l, b_l)],
            [b if len(a) <= len(b) else a for a, b in zip(a_l, b_l)])


def drive_untraced(a_l, b_l, k: int, costs, name: str):
    """One untraced call of `levenshtein_k_batch` with K3's launch count set
    to 0 just before it and read just after: (distances, e2e seconds,
    launches, the dispatch decision).  Checks the route (`band`) and that
    every pair came back as an int64 distance within the threshold."""
    import triple_accel_tpu_torch as tt
    from triple_accel_tpu_torch.dispatch import dispatch_history
    from triple_accel_tpu_torch.ops import lev_band as lb

    dispatch_history(clear=True)
    lb.band_distance.launches = 0  # 0 just before the path ...
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = tt.levenshtein_k_batch(a_l, b_l, k, costs)
    torch.cuda.synchronize()
    e2e_s = time.perf_counter() - t0
    launches = lb.band_distance.launches  # ... read just after it
    hist = dispatch_history()
    check(launches >= 1 and {d.path for _, d in hist} == {"band"},
          f"{name}: {launches} launches over {[d.path for _, d in hist]}")
    check(out.shape == (len(a_l),) and out.dtype == np.int64,
          f"{name}: result has the wrong shape or type")
    check(bool(((out >= 0) & (out <= k)).all()),
          f"{name}: an edited pair came back outside [0, {k}]")
    return out, e2e_s, launches, hist[-1][1]


def run_band_wide(dev, scale: float, native_loaded: bool):
    """K3 / K4's block regime (bands of 545 - 9,281 cells) through the entry
    points, cases (a) - (d) of WIDE_*, then K4's cluster regime past a
    cluster's columns, cases (e) and (f) (`run_wide_ring`).  Every
    distance within the threshold and every trace is checked; returns the
    `kernels` entries."""
    import triple_accel_tpu_torch as tt
    from triple_accel_tpu_torch.dispatch import dispatch_history
    from triple_accel_tpu_torch.ops import lev_band as lb
    from triple_accel_tpu_torch.ops import myers_chunked as mc
    from triple_accel_tpu_torch.utils.native import (
        myers_distance_batch_native, scalar_banded_batch_native)

    t_phase = time.perf_counter()
    pool = ThreadPoolExecutor(max_workers=6)
    entries = []

    def pow2(x):  # the untraced engines' band: unit_k up to a power of two
        return 1 << (x - 1).bit_length()

    def plan_of(dec, n_pairs, traced, max_n):
        plan = lb.band_plan(dec.padded_m, dec.unit_k, traced, batch=n_pairs,
                            max_n=max_n)
        return {k_: plan[k_] for k_ in ("regime", "cells_per_lane",
                                        "warps_per_pair", "threads")}

    # (a) unit costs, then rDamerau with swaps, band 2,049
    n_a = max(64, int(WIDE_PAIRS * scale))
    t0 = time.perf_counter()
    a_l, b_l = make_long_pairs(n_a, WIDE_LEN, WIDE_EDIT_SHARE, seed=6060)
    b_sw = swap_adjacent_list(b_l, WIDE_SWAP_SHARE,
                              np.random.default_rng(6061))
    gen_s = time.perf_counter() - t0
    for costs, b_rows, name in ((tt.LEVENSHTEIN_COSTS, b_l,
                                 "band_distance_wide"),
                                (tt.RDAMERAU_COSTS, b_sw,
                                 "band_distance_wide_rdamerau")):
        unit = costs == tt.LEVENSHTEIN_COSTS
        out, e2e_s, launches, dec = drive_untraced(a_l, b_rows, K_WIDE,
                                                   costs, name)
        # the comparators start after the timed call, beside the kernel's
        if unit:
            ref = native_beside(pool, myers_distance_batch_native, a_l,
                                b_rows, K_WIDE)
        else:
            ref = native_beside(pool, scalar_banded_batch_native,
                                a_l[:WIDE_NATIVE_PAIRS],
                                b_rows[:WIDE_NATIVE_PAIRS], K_WIDE, costs)
        plan = plan_of(dec, n_a, False, WIDE_LEN * 2)
        check(dec.unit_k == pow2(K_WIDE) and plan["regime"] == "wide",
              f"{name}: unit_k {dec.unit_k}, plan {plan}")
        sa, sb = shorter_first(a_l, b_rows)
        numbers, phase, _ = band_kernel_only(
            dev, sa, sb, dec, costs, False, out, 7,
            plain_pairs=WIDE_PLAIN_PAIRS)
        got = ref()
        if native_loaded:
            check(got is not None and np.array_equal(out[:len(got)], got),
                  f"{name}: != the compiled comparator")
        entries.append(band_entry(name, "wide", False, "402", launches,
                                  numbers))
        emit({"phase": "band_wide", "case": "a", "name": name,
              "pairs": n_a, "str_len": WIDE_LEN, "k": K_WIDE,
              "costs": "LEVENSHTEIN_COSTS" if unit else "RDAMERAU_COSTS",
              "reference": (("myers_distance_batch_native, every pair"
                             if unit else
                             f"ta_scalar_banded_batch, the first "
                             f"{WIDE_NATIVE_PAIRS} pairs")
                            if native_loaded else "none (no native library)"),
              "datagen_s": round(gen_s, 2), "e2e_s": round(e2e_s, 4),
              "pairs_per_s_e2e": round(n_a / e2e_s, 1),
              "pairs_per_s_kernel": round(n_a / (numbers["ms"] * 1e-3), 1),
              "launches": launches, **plan, **phase})

    # (b) the first pairs of (a) traced, rDamerau, band 2,017
    n_b = max(32, int(WIDE_TRACE_PAIRS * scale))
    ta_l, tb_l = a_l[:n_b], b_sw[:n_b]
    name = "band_trace_wide"
    out, traces, e2e_s, launches, walks, dec = drive_traced(
        ta_l, tb_l, K_WIDE, tt.RDAMERAU_COSTS, name, "band_trace")
    plan = plan_of(dec, n_b, True, WIDE_LEN * 2)
    check(dec.unit_k == -(-K_WIDE // 16) * 16 and plan["regime"] == "wide",
          f"{name}: unit_k {dec.unit_k}, plan {plan}")
    split = band_trace_split(ta_l, tb_l, K_WIDE, tt.RDAMERAU_COSTS, out,
                             traces)
    ref = native_beside(pool, scalar_banded_batch_native,
                        ta_l[:WIDE_NATIVE_PAIRS], tb_l[:WIDE_NATIVE_PAIRS],
                        K_WIDE, tt.RDAMERAU_COSTS)
    sa, sb = shorter_first(ta_l, tb_l)
    numbers, phase, walk = band_kernel_only(
        dev, sa, sb, dec, tt.RDAMERAU_COSTS, True, out, 7,
        plain_pairs=WIDE_PLAIN_PAIRS, walk_reps=5)
    got = ref()
    if native_loaded:
        check(got is not None and np.array_equal(out[:len(got)], got),
              f"{name}: != the compiled comparator")
    entries.append(band_entry(name, "wide", True, "773", launches, numbers))
    entries.append(walk_entry("trace_walk_wide", walks, walk))
    emit({"phase": "band_wide", "case": "b", "name": name, "pairs": n_b,
          "str_len": WIDE_LEN, "k": K_WIDE, "costs": "RDAMERAU_COSTS",
          "traces_replayed": n_b, "launches": launches,
          "walk_launches": walks, "e2e_s": round(e2e_s, 4),
          "pairs_per_s_e2e": round(n_b / e2e_s, 1),
          "pairs_per_s_kernel": round(n_b / (numbers["ms"] * 1e-3), 1),
          "e2e_split_s": split, **plan, **phase})

    # (c) affine costs at k = 4000, band 8,193
    n_c, length, share, k_c = WIDE_AFFINE
    n_c = max(16, int(n_c * scale))
    affine = tt.EditCosts(*AFFINE)
    name = "band_distance_wide_affine"
    t0 = time.perf_counter()
    a_l, b_l = make_long_pairs(n_c, length, share, seed=6062)
    gen_s = time.perf_counter() - t0
    out, e2e_s, launches, dec = drive_untraced(a_l, b_l, k_c, affine, name)
    ref = native_beside(pool, scalar_banded_batch_native,
                        a_l[:WIDE_NATIVE_PAIRS], b_l[:WIDE_NATIVE_PAIRS],
                        k_c, affine)
    plan = plan_of(dec, n_c, False, length * 2)
    # affine (2, 1, 2): unit_k = (k - start) / gap
    check(dec.unit_k == pow2(k_c - 2) and plan["regime"] == "wide",
          f"{name}: unit_k {dec.unit_k}, plan {plan}")
    sa, sb = shorter_first(a_l, b_l)
    numbers, phase, _ = band_kernel_only(dev, sa, sb, dec, affine, False,
                                         out, 7, plain_pairs=WIDE_PLAIN_PAIRS)
    got = ref()
    if native_loaded:
        check(got is not None and np.array_equal(out[:len(got)], got),
              f"{name}: != the compiled comparator")
    entries.append(band_entry(name, "wide", False, "402", launches, numbers))
    emit({"phase": "band_wide", "case": "c", "name": name, "pairs": n_c,
          "str_len": length, "k": k_c, "costs": list(AFFINE),
          "datagen_s": round(gen_s, 2), "e2e_s": round(e2e_s, 4),
          "pairs_per_s_e2e": round(n_c / e2e_s, 1),
          "pairs_per_s_kernel": round(n_c / (numbers["ms"] * 1e-3), 1),
          "launches": launches, **plan, **phase})

    # (d) the front door on one pair, band 4,097
    length, share = WIDE_FRONT
    (a,), (b,) = make_long_pairs(1, length, share, seed=6063)
    b_swp = swap_adjacent_list([b], WIDE_SWAP_SHARE,
                               np.random.default_rng(6064))[0]
    for fn, costs, y, ref_fn in (
            (tt.levenshtein, tt.LEVENSHTEIN_COSTS, b,
             lambda: myers_distance_batch_native([a], [b], U32_MAX)),
            (tt.rdamerau, tt.RDAMERAU_COSTS, b_swp,
             lambda: scalar_banded_batch_native([a], [b_swp], U32_MAX,
                                                tt.RDAMERAU_COSTS))):
        secs = []
        for _ in range(5):
            dispatch_history(clear=True)
            lb.band_distance.launches = 0  # 0 just before the path ...
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            d = fn(a, y)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            launches = lb.band_distance.launches  # ... read just after it
            hist = dispatch_history()
            check(launches == 1 and [h.path for _, h in hist] == ["band"],
                  f"front door {fn.__name__}: {launches} launches over "
                  f"{[h.path for _, h in hist]}")
        dec = hist[-1][1]
        plan = plan_of(dec, 1, False, max(len(a), len(y)))
        check(dec.unit_k == pow2(max(len(a), len(y)))
              and plan["regime"] == "wide",
              f"front door {fn.__name__}: unit_k {dec.unit_k}, plan {plan}")
        if native_loaded:
            exp = ref_fn()
            check(exp is not None and int(exp[0]) == d,
                  f"front door {fn.__name__}: {d} != comparator {exp}")
        sa, sb = shorter_first([a], [y])
        numbers, phase, _ = band_kernel_only(
            dev, sa, sb, dec, costs, False, np.array([d]), 15)
        emit({"phase": "band_wide", "case": "d",
              "name": f"front_door_{fn.__name__}", "pairs": 1,
              "str_len": [len(a), len(y)], "distance": d,
              "e2e_s": round(statistics.median(secs), 4),
              "e2e_s_first": round(secs[0], 4), "launches": launches,
              "kernel_ms": round(numbers["ms"], 4),
              "kernel_ms_min_max": [round(numbers["ms_min"], 4),
                                    round(numbers["ms_max"], 4)],
              "bound_ms": numbers["bound_ms"],
              "note": "one pair: latency-bound, no roofline applies",
              **plan, **phase})

    # (e), (f): K4's cluster regime past a cluster's columns (b strings
    # of 90,000 bytes: 176 strips of 512 columns, 21 of which meet a row),
    # its warps a ring over them
    for case, (n_x, length, share, k_x), seed in (
            ("e", WIDE_DEEP, 6065),
            ("f", (max(2, int(WIDE_DEEP_F[0] * scale)),) + WIDE_DEEP_F[1:],
             6066)):
        entries.append(run_wide_ring(dev, case, n_x, length, share, k_x,
                                     seed))
    pool.shutdown()
    emit({"phase": "band_wide", "case": "done",
          "phase_s": round(time.perf_counter() - t_phase, 1)})
    return entries


def run_wide_ring(dev, case: str, n_x: int, length: int, share: float,
                  k_x: int, seed: int) -> dict:
    """`band_wide` case (e) or (f): `n_x` traced pairs of `length` ACGT
    bytes with `share` of edits at k_x under rDamerau costs, b past what a
    cluster held at once, through `levenshtein_k_batch` (the plan must be
    the cluster regime with fewer warps than strips); distances against
    the untraced call (K5), every trace replayed; the kernel once more
    alone, timed, and against the plain version at the same plan on the
    first WIDE_DEEP_CUT bytes of the first WIDE_PLAIN_PAIRS pairs.  (e)
    also gives `e2e_split_s`.  Returns the `kernels` entry."""
    import triple_accel_tpu_torch as tt
    from triple_accel_tpu_torch.ops import band_scan as bs
    from triple_accel_tpu_torch.ops import lev_band as lb
    from triple_accel_tpu_torch.ops import myers_chunked as mc

    name = f"band_trace_ring_{case}"
    t0 = time.perf_counter()
    a_l, b_l = make_long_pairs(n_x, length, share, seed=seed)
    gen_s = time.perf_counter() - t0
    out, traces, e2e_s, launches, walks, dec = drive_traced(
        a_l, b_l, k_x, tt.RDAMERAU_COSTS, name, "band_trace_global")
    sa, sb = shorter_first(a_l, b_l)
    max_n = max(len(x) for x in sb)
    plan = lb.band_plan(dec.padded_m, dec.unit_k, True, batch=n_x,
                        max_n=max_n)
    strips = -(-(max_n + 3) // 512)
    check(plan["regime"] == "wide_cluster"
          and plan["warps_per_pair"] < strips and not plan["full_band"],
          f"{name}: plan {plan} for {strips} strips")
    mc.blocked_distance.launches = 0
    untraced = tt.levenshtein_k_batch(a_l, b_l, k_x, tt.RDAMERAU_COSTS)
    check(mc.blocked_distance.launches >= 1,
          f"{name}: the untraced call did not take K5")
    check(np.array_equal(untraced, out),
          f"{name}: traced distances != the untraced call's (K5)")
    split = (band_trace_split(a_l, b_l, k_x, tt.RDAMERAU_COSTS, out, traces)
             if case == "e" else None)
    ct = costs_tuple(tt.RDAMERAU_COSTS)
    t = lb.prepare_band_tensors(sa, sb, dec.unit_k, dec.padded_m, device=dev)
    kw = dict(unit_k=dec.unit_k, costs_t=ct)
    times = time_launches(lambda: lb.band_trace(*t, **kw), 3)
    got_d, got_codes = lb.band_trace(*t, **kw)
    check(np.array_equal(got_d.cpu().numpy().astype(np.int64), out),
          f"{name}: kernel-only rerun != main path result")
    code_mb = got_codes.numel() * 4 / 1e6
    bound = prof.k4_bound(t[2].cpu().numpy(), t[3].cpu().numpy(),
                          dec.unit_k, ct)
    del got_codes, t
    torch.cuda.empty_cache()
    # the same launch shape against the plain version on a prefix
    n_cut = min(WIDE_PLAIN_PAIRS, n_x)
    cut = lb.prepare_band_tensors(
        [x[:WIDE_DEEP_CUT] for x in sa[:n_cut]],
        [y[:WIDE_DEEP_CUT] for y in sb[:n_cut]],
        dec.unit_k, WIDE_DEEP_CUT, device=dev)
    cut_d, cut_codes = lb.band_trace(*cut, plan=plan, **kw)
    ref = None

    def run_plain():
        nonlocal ref
        ref = bs.band_scan_distance(*cut, trace_on=True, **kw)

    plain_ms = time_once_ms(run_plain)
    err = band_errors(cut_d, cut_codes, ref[0], ref[1], cut, dec.unit_k,
                      False)
    check(err == 0, f"{name}: != plain on the {WIDE_DEEP_CUT}-byte prefix")
    rows = dec.padded_m
    emit({"phase": "band_wide", "case": case, "name": name, "pairs": n_x,
          "str_len": length, "edit_share": share, "k": k_x,
          "costs": "RDAMERAU_COSTS", "unit_k": dec.unit_k,
          "band_cells": 2 * dec.unit_k + 1, "rows": rows,
          "strips_per_pair": strips, "traces_replayed": n_x,
          "launches": launches, "walk_launches": walks,
          "reference": "K5 on every pair", "datagen_s": round(gen_s, 3),
          "code_MB": round(code_mb, 1),
          "wrap_MB": round(n_x * plan["scratch_bytes_per_pair"] / 1e6, 1),
          "e2e_s": round(e2e_s, 4), "e2e_split_s": split,
          "kernel_ms": round(times[0], 4),
          "kernel_ms_min_max": [round(times[1], 4), round(times[2], 4)],
          "us_per_row": round(times[0] * 1e3 / max(rows, 1), 3),
          "bound_ms": bound["bound_ms"],
          "plain_ms_at_cut": round(plain_ms, 1),
          "plain_cut": [n_cut, WIDE_DEEP_CUT],
          **{k_: plan[k_] for k_ in ("regime", "ctas_per_pair", "threads",
                                     "warps_per_pair", "full_band")}})
    return band_entry(name, "wide_cluster", True, "773", launches, {
        "kernel": "band_cluster_kernel<*>", "max_abs_err": err,
        "ms": times[0], "ms_min": times[1], "ms_max": times[2],
        "plain_ms": plain_ms,
        "plain_shape": f"the first {WIDE_DEEP_CUT} bytes of the first "
                       f"{n_cut} pairs, the same band and plan",
        "library_ms": None,
        **{k_: bound[k_] for k_ in ("bound_ms", "bound_by", "bound_bytes_ms",
                                    "bound_operations_ms")}})


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


# ---------------------------------------------------------------------------
# the blocked phases: unbounded lengths, long needles
# ---------------------------------------------------------------------------

# the plain versions pay one Python step a column, so they are timed and
# held against the kernels at a cut, unit costs (kernel_checks holds both
# cost models): the first pairs with texts cut to this many bytes, the
# first bytes of the haystack
BLOCKED_PLAIN_PAIRS, BLOCKED_PLAIN_COLS = 16, 2000
LONG_SEARCH_PLAIN_BYTES, LONG_SEARCH_PLAIN_OWN = 64 << 10, 1024


def blocked_pairs(scale: float):
    """The `blocked_distance` phase's pairs (BLOCKED_PAIRS at full scale)
    and the seconds they took to make."""
    t0 = time.perf_counter()
    pairs = make_long_pairs(max(64, int(BLOCKED_PAIRS * scale)), BLOCKED_LEN,
                            BLOCKED_EDIT_SHARE, seed=2020)
    return pairs, time.perf_counter() - t0


def flat_distance_pairs(scale: float):
    """The `flat_distance` phase's pairs (FLAT_DIST_PAIRS at full scale)
    and the seconds they took to make."""
    t0 = time.perf_counter()
    pairs = make_long_pairs(max(16, round(FLAT_DIST_PAIRS * scale)),
                            FLAT_DIST_LEN, FLAT_DIST_EDIT_SHARE, seed=5050)
    return pairs, time.perf_counter() - t0


def run_blocked_distance(dev, pairs, gen_s: float, native_loaded: bool):
    """Exact distances past the band plan: unit costs, then rDamerau on the
    same pairs with adjacent swaps added.  `pairs` and `gen_s` come from
    `blocked_pairs`."""
    import triple_accel_tpu_torch as tt
    from triple_accel_tpu_torch.dispatch import dispatch_history
    from triple_accel_tpu_torch.ops import myers_chunked as mc
    from triple_accel_tpu_torch.utils.native import (
        myers_distance_batch_native, scalar_banded_batch_native)

    check(native_loaded, "the blocked phases need the compiled comparators "
                         "of native/ (a Python oracle takes hours there)")
    a_list, b_list = pairs
    n_pairs = len(a_list)
    t_phase = t0 = time.perf_counter()
    b_swapped = swap_adjacent_list(b_list, BLOCKED_SWAP_SHARE,
                                   np.random.default_rng(2021))
    gen_s += time.perf_counter() - t0

    def drive(b_l, costs, what):
        dispatch_history(clear=True)
        mc.blocked_distance.launches = 0  # 0 just before the path ...
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = tt.levenshtein_k_batch(a_list, b_l, U32_MAX, costs)
        torch.cuda.synchronize()
        e2e_s = time.perf_counter() - t0
        launches = mc.blocked_distance.launches  # ... read just after it
        paths = {d.path for _, d in dispatch_history()}
        check(launches >= 1, f"{what}: no blocked_distance kernel launched")
        check(paths == {"myers_blocked_distance"},
              f"{what}: dispatch took {paths}")
        check(out.shape == (n_pairs,) and out.dtype == np.int64
              and bool((out > 0).all()), f"{what}: wrong shape, type or sign")
        return out, e2e_s, launches

    out_u, e2e_u, launches_u = drive(b_list, tt.LEVENSHTEIN_COSTS, "unit")
    out_r, e2e_r, launches_r = drive(b_swapped, tt.RDAMERAU_COSTS,
                                     "rdamerau")
    n_ref = min(128, n_pairs)
    ref = myers_distance_batch_native(a_list[:n_ref], b_list[:n_ref],
                                      U32_MAX)
    check(np.array_equal(out_u[:n_ref], ref),
          "unit distances != compiled CPU Myers comparator")
    # rDamerau: the scalar banded comparator, its band narrowed to the
    # pairs' unit distance (an upper bound of the rDamerau one)
    unit_sw = myers_distance_batch_native(a_list[:4], b_swapped[:4], U32_MAX)
    ref_r = scalar_banded_batch_native(a_list[:4], b_swapped[:4],
                                       int(unit_sw.max()), tt.RDAMERAU_COSTS)
    check(np.array_equal(out_r[:4], ref_r),
          "rDamerau distances != compiled scalar banded comparator")
    check(bool((ref_r < unit_sw).all()),
          "adjacent swaps never made a pair cheaper than unit costs")

    # kernel only, at the tensors the main path gives it
    a_s = [a if len(a) <= len(b) else b for a, b in zip(a_list, b_list)]
    b_s = [b if len(a) <= len(b) else a for a, b in zip(a_list, b_list)]
    a_r = [a if len(a) <= len(b) else b for a, b in zip(a_list, b_swapped)]
    b_r = [b if len(a) <= len(b) else a for a, b in zip(a_list, b_swapped)]
    times, bounds = {}, {}
    for damerau, (a_l, b_l), out in ((False, (a_s, b_s), out_u),
                                     (True, (a_r, b_r), out_r)):
        t0 = time.perf_counter()
        t = mc.prepare_blocked_distance_inputs(a_l, b_l, device=dev)
        torch.cuda.synchronize()
        prep_s = time.perf_counter() - t0
        got = mc.blocked_distance(*t, damerau=damerau)
        check(np.array_equal(got.cpu().numpy().astype(np.int64), out),
              "kernel-only rerun != main path result")
        times[damerau] = time_launches(
            lambda: mc.blocked_distance(*t, damerau=damerau), 7)
        bounds[damerau] = prof.k5_bound(t[2].cpu().numpy(),
                                        t[3].cpu().numpy(), damerau)
        if not damerau:
            # the plain version at a cut of the unit-cost tensors
            cut = BLOCKED_PLAIN_COLS
            tc = (t[0][:BLOCKED_PLAIN_PAIRS],
                  t[1][:BLOCKED_PLAIN_PAIRS, :cut].contiguous(),
                  t[2][:BLOCKED_PLAIN_PAIRS],
                  t[3][:BLOCKED_PLAIN_PAIRS].clamp(max=cut))
            got_c = mc.blocked_distance(*tc)
            ref_c = None

            def run_plain():
                nonlocal ref_c
                ref_c = mc.blocked_distance_plain(*tc)

            plain_ms = time_once_ms(run_plain)
            worst = int((got_c.to(torch.int64) - ref_c.to(torch.int64))
                        .abs().max())
            check(worst == 0, "blocked_distance != plain at the cut of the "
                              "main-path tensors")
        del t, got
    emit({"phase": "blocked_distance", "pairs": n_pairs,
          "str_len": BLOCKED_LEN, "edits": BLOCKED_EDIT_SHARE,
          "swaps_rdamerau": BLOCKED_SWAP_SHARE, "k": "U32_MAX",
          "dispatch": "myers_blocked_distance",
          "launches": {"unit": launches_u, "rdamerau": launches_r},
          "reference": f"ta_myers_distance_batch ({n_ref} pairs), "
                       "ta_scalar_banded_batch (4 pairs)",
          "datagen_s": round(gen_s, 3),
          "input_MB": round(sum(len(a) + len(b) for a, b in zip(
              a_list, b_list)) / 1e6, 1),
          "e2e_s": {"unit": round(e2e_u, 4), "rdamerau": round(e2e_r, 4)},
          "pairs_per_s_e2e": {"unit": round(n_pairs / e2e_u, 1),
                              "rdamerau": round(n_pairs / e2e_r, 1)},
          "host_prep_and_upload_s": round(prep_s, 4),
          "kernel_ms_median_min_max": {
              "unit": [round(x, 4) for x in times[False]],
              "rdamerau": [round(x, 4) for x in times[True]]},
          "pairs_per_s_kernel": round(n_pairs / (times[False][0] * 1e-3), 1),
          "plain_cut": [BLOCKED_PLAIN_PAIRS, BLOCKED_PLAIN_COLS],
          "plain_ms": round(plain_ms, 1),
          "phase_s": round(time.perf_counter() - t_phase, 1)})
    return {
        "name": "blocked_distance", "route": "cuda",
        "source": "triple_accel_tpu_torch/csrc/myers_blocked.cu",
        "kernel": "blocked_kernel<W, *, false>, distance mode",
        "map": mc.blocked_plan(BLOCKED_LEN, len(ACGT) + 1),
        "replaces": "triple_accel_tpu/ops/pallas/myers_chunked.py:69",
        "launches": launches_u + launches_r, "max_abs_err": worst,
        "ms": times[False][0], "ms_min": times[False][1],
        "ms_max": times[False][2],
        "plain_ms": plain_ms,
        "plain_shape": f"{BLOCKED_PLAIN_PAIRS} pairs, texts cut to "
                       f"{BLOCKED_PLAIN_COLS} bytes",
        **bounds[False], "library_ms": None,
        # the restricted-Damerau launches of the same path
        "ms_rdamerau": times[True][0],
        "bound_ms_rdamerau": bounds[True]["bound_ms"],
    }


def run_blocked_search(dev, hay_mb: int, native_loaded: bool):
    """A long needle over a genome-sized haystack: unanchored at k = 150,
    Best and All, unit and rDamerau; then anchored at a copy planted at 0
    with a threshold whose window the JAX package tiles with its chunked
    engine."""
    from triple_accel_tpu_torch.dispatch import dispatch_history
    from triple_accel_tpu_torch.levenshtein import (
        _RESOLVE_CELLS_BUDGET, _resolve_cells,
        levenshtein_search_simd_with_opts)
    from triple_accel_tpu_torch.ops import myers_chunked as mc
    from triple_accel_tpu_torch.ops.myers_search import prepare_myers_needles
    from triple_accel_tpu_torch.ops.search_common import window_span
    from triple_accel_tpu_torch.types import (
        LEVENSHTEIN_COSTS, RDAMERAU_COSTS, SearchType)
    from triple_accel_tpu_torch.utils.native import (
        search_all_native, search_intervals_native)

    check(native_loaded, "the blocked phases need the compiled comparators "
                         "of native/")
    m, k = LONG_NEEDLE_LEN, K_LONG_NEEDLE
    t_phase = t0 = time.perf_counter()
    needle, hay, planted = make_long_haystack(
        hay_mb << 20, m, N_PLANTED_LONG, LONG_NEEDLE_SUBS, seed=3030)
    gen_s = time.perf_counter() - t0
    n = len(hay)
    costs_of = {"unit": LEVENSHTEIN_COSTS, "rdamerau": RDAMERAU_COSTS}

    dispatch_history(clear=True)
    mc.blocked_search.launches = 0  # 0 just before the path ...
    results, e2e = {}, {}
    for cname, costs in costs_of.items():
        for st in (SearchType.Best, SearchType.All):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            results[(cname, st)] = levenshtein_search_simd_with_opts(
                needle, hay, k, st, costs, False)
            torch.cuda.synchronize()
            e2e[f"{cname}_{st.name}"] = time.perf_counter() - t0
    launches = mc.blocked_search.launches  # ... read just after it
    paths = [d.path for _, d in dispatch_history()]
    check(launches == 4, f"4 long-needle searches launched {launches}")
    check(paths == ["myers_search_blocked"] * 4,
          f"long-needle dispatch took {paths}")

    starts, ends = long_search_intervals(planted, m, k, n)
    # the references cost about 3e9 cells each (the copy-free tail times
    # the needle): independent C++ calls that release the interpreter lock,
    # so both run side by side
    with ThreadPoolExecutor(len(costs_of)) as pool:
        futures = {cname: pool.submit(search_intervals_native, needle, hay,
                                      starts, ends, k, costs)
                   for cname, costs in costs_of.items()}
        refs = {cname: f.result() for cname, f in futures.items()}
    replay_cells = {}
    for cname, costs in costs_of.items():
        all_m = results[(cname, SearchType.All)]
        by_end = {mt.end: mt for mt in all_m}
        for pos in planted.tolist():
            mt = by_end.get(pos + m)
            check(mt is not None and mt.k <= LONG_NEEDLE_SUBS,
                  f"{cname}: planted copy at {pos} not found with k <= "
                  f"{LONG_NEEDLE_SUBS}")
        best = results[(cname, SearchType.Best)]
        kmin = min(mt.k for mt in all_m)
        check(best and all(mt.k == kmin for mt in best)
              and all(by_end.get(mt.end) is not None for mt in best),
              f"{cname}: Best-mode matches are not the minimum-cost ones")
        ref_e, ref_k, ref_l = refs[cname]
        check([(mt.start, mt.end, mt.k) for mt in all_m]
              == list(zip((ref_e - ref_l).tolist(), ref_e.tolist(),
                          ref_k.tolist())),
              f"{cname}: All-mode matches != the compiled scalar search "
              "over the copies' windows and the copy-free tail")
        replay_cells[cname] = _resolve_cells(
            np.array([mt.end for mt in all_m], np.int64), m + k, m)
        check(replay_cells[cname] <= _RESOLVE_CELLS_BUDGET,
              f"{cname}: the All-mode replay passed its budget")

    # anchored at the copy planted at 0: one segment of m + k columns
    k_a = K_ANCHORED_LONG
    mc.blocked_search.launches = 0  # 0 just before the path ...
    anchored, e2e_a = {}, {}
    for st in (SearchType.Best, SearchType.All):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        anchored[st] = levenshtein_search_simd_with_opts(
            needle, hay, k_a, st, LEVENSHTEIN_COSTS, True)
        torch.cuda.synchronize()
        e2e_a[st.name] = time.perf_counter() - t0
    launches_a = mc.blocked_search.launches  # ... read just after it
    check(launches_a == 2, f"2 anchored searches launched {launches_a}")
    ref_e, ref_k, ref_l = search_all_native(needle, hay, k_a,
                                            LEVENSHTEIN_COSTS, anchored=True)
    all_a = [(mt.start, mt.end, mt.k) for mt in anchored[SearchType.All]]
    check(all_a == list(zip((ref_e - ref_l).tolist(), ref_e.tolist(),
                            ref_k.tolist())),
          "anchored All-mode matches != the compiled scalar search")
    best_a = anchored[SearchType.Best]
    check(best_a and best_a[0].start == 0
          and best_a[0].k <= LONG_NEEDLE_SUBS
          and all(mt.k == min(ref_k.tolist()) for mt in best_a),
          f"anchored Best-mode gave {best_a[:3]}")

    # kernel only, at the tensors the main path gives it
    halo = min(-(-window_span(m, k, 1, 0) // 256) * 256, n)
    own_len = mc.suggest_own_len_blocked(n, halo)
    hay_d = torch.from_numpy(hay).to(dev)
    nd = prepare_myers_needles([needle], m, device=dev)
    times = {damerau: time_launches(
        lambda: mc.blocked_search(hay_d, nd, own_len=own_len, halo=halo,
                                  damerau=damerau), 5)
        for damerau in (False, True)}
    # the plain version at a cut: the haystack's first bytes, unit costs
    cut = hay_d[:LONG_SEARCH_PLAIN_BYTES]
    kw = dict(own_len=LONG_SEARCH_PLAIN_OWN, halo=halo)
    got = mc.blocked_search(cut, nd, **kw)
    ref = None

    def run_plain():
        nonlocal ref
        ref = mc.blocked_search_plain(cut, nd, **kw)

    plain_ms = time_once_ms(run_plain)
    worst = int((got.to(torch.int64) - ref.to(torch.int64)).abs().max())
    check(worst == 0, "blocked_search != plain at the cut of the haystack")
    # the anchored (chunked) regime at its full shape, plain version too
    it_a = min(m + k_a, n)
    hay_a = hay_d[:it_a]
    times_a = time_launches(
        lambda: mc.blocked_search(hay_a, nd, own_len=it_a, halo=0,
                                  anchored=True), 9)
    got = mc.blocked_search(hay_a, nd, own_len=it_a, halo=0, anchored=True)
    ref = None

    def run_plain_a():
        nonlocal ref
        ref = mc.blocked_search_plain(hay_a, nd, own_len=it_a, halo=0,
                                      anchored=True)

    plain_a = time_once_ms(run_plain_a)
    err_a = int((got.to(torch.int64) - ref.to(torch.int64)).abs().max())
    check(err_a == 0, "blocked_search != plain at the anchored shape")
    bound = prof.k6_bound(n, m, False)
    bound_r = prof.k6_bound(n, m, True)
    bound_a = prof.k6_bound(it_a, m, False)
    plan_rows = len(set(needle.tolist())) + 1
    plan = mc.blocked_plan(m, plan_rows, search=True,
                           segments=-(-n // own_len))
    emit({"phase": "blocked_search", "haystack_bytes": n, "needle_len": m,
          "k": k, "planted": N_PLANTED_LONG,
          "planted_subs": LONG_NEEDLE_SUBS, "halo": halo,
          "own_len": own_len, "segments": -(-n // own_len), "map": plan,
          "dispatch": "myers_search_blocked", "launches": launches,
          "matches": {f"{c}_{st.name}": len(r)
                      for (c, st), r in results.items()},
          "reference": "ta_search_intervals over the copies' windows and "
                       f"the last {COPY_FREE_BYTES} bytes",
          "replay_cells": replay_cells,
          "replay_budget": _RESOLVE_CELLS_BUDGET,
          "datagen_s": round(gen_s, 3),
          "e2e_s": {k_: round(v, 4) for k_, v in e2e.items()},
          "GBps_e2e": {k_: round(n / v / 1e9, 3) for k_, v in e2e.items()},
          "kernel_ms_median_min_max": {
              "unit": [round(x, 4) for x in times[False]],
              "rdamerau": [round(x, 4) for x in times[True]]},
          "GBps_kernel": {
              "unit": round(n / (times[False][0] * 1e-3) / 1e9, 3),
              "rdamerau": round(n / (times[True][0] * 1e-3) / 1e9, 3)},
          "plain_cut": [LONG_SEARCH_PLAIN_BYTES, LONG_SEARCH_PLAIN_OWN],
          "plain_ms": round(plain_ms, 1),
          "anchored": {"k": k_a, "columns": it_a, "launches": launches_a,
                       "matches": {st.name: len(r)
                                   for st, r in anchored.items()},
                       "e2e_s": {k_: round(v, 4) for k_, v in e2e_a.items()},
                       "kernel_ms": round(times_a[0], 4),
                       "plain_ms": round(plain_a, 1)},
          "phase_s": round(time.perf_counter() - t_phase, 1)})
    source = "triple_accel_tpu_torch/csrc/myers_blocked.cu"
    entries = [{
        "name": "blocked_search", "route": "cuda", "source": source,
        "kernel": "blocked_kernel<W, *, true>, search mode",
        "regime": "blocked", "map": plan,
        "replaces": "triple_accel_tpu/ops/pallas/search_myers.py:938",
        "launches": launches, "max_abs_err": worst,
        "ms": times[False][0], "ms_min": times[False][1],
        "ms_max": times[False][2], "plain_ms": plain_ms,
        "plain_shape": f"the haystack's first {LONG_SEARCH_PLAIN_BYTES} "
                       f"bytes, own_len {LONG_SEARCH_PLAIN_OWN}",
        **bound, "library_ms": None,
        "ms_rdamerau": times[True][0],
        "bound_ms_rdamerau": bound_r["bound_ms"],
    }, {
        "name": "blocked_search_chunked", "route": "cuda", "source": source,
        "kernel": "blocked_kernel<W, *, true>, search mode",
        "map": mc.blocked_plan(m, plan_rows, search=True, segments=1),
        "regime": f"chunked (anchored, {it_a} columns)",
        "replaces": "triple_accel_tpu/ops/pallas/myers_chunked.py:386",
        "launches": launches_a, "max_abs_err": err_a,
        "ms": times_a[0], "ms_min": times_a[1], "ms_max": times_a[2],
        "plain_ms": plain_a, **bound_a, "library_ms": None,
    }]
    return entries


def copy_windows(planted: np.ndarray, m: int, span: int, n: int,
                 free_start: int, free_len: int):
    """Disjoint intervals around every planted copy (from one window span
    before it to one after its end: every candidate that overlaps a copy
    lies there with its whole window) and one copy-free stretch."""
    starts = np.append(np.maximum(planted - span, 0), free_start)
    ends = np.append(np.minimum(planted + m + span, n),
                     min(free_start + free_len, n))
    return merge_intervals(starts, ends)


def copy_free_start(planted: np.ndarray, m: int, span: int, n: int,
                    length: int) -> int:
    """The start of a stretch of `length` bytes that no copy's window
    reaches (the first gap between copies wide enough)."""
    edges = np.concatenate([[0], np.sort(planted) + m + span, [n]])
    starts = np.concatenate([[0], np.sort(planted) - span, [n]])
    for lo, hi in zip(edges[:-1].tolist(), starts[1:].tolist()):
        if hi - lo >= length:
            return int(lo)
    raise RuntimeError("chip_smoke: no copy-free stretch in the haystack")


def check_all_mode(name: str, all_m, ref) -> None:
    ref_e, ref_k, ref_l = ref
    check([(mt.start, mt.end, mt.k) for mt in all_m]
          == list(zip((ref_e - ref_l).tolist(), ref_e.tolist(),
                      ref_k.tolist())),
          f"{name}: All-mode matches != the compiled scalar search over the "
          "copies' windows and the copy-free stretch")


def check_best_mode(name: str, best, all_m) -> None:
    by_end = {mt.end: mt for mt in all_m}
    kmin = min((mt.k for mt in all_m), default=None)
    check(bool(best) == bool(all_m) and all(mt.k == kmin for mt in best)
          and all(mt.end in by_end for mt in best),
          f"{name}: Best-mode matches are not the minimum-cost ones")


def run_search_general(dev, needle, hay, planted, native_loaded: bool):
    """General-cost search with a short needle (K7): the search phase's
    haystack and planted copies at k = K_GENERAL under GENERAL_COSTS, Best
    and All, then one anchored call at a planted copy; against the
    compiled scalar search over the copies' windows and a copy-free
    stretch (anchored: over the anchored window)."""
    from triple_accel_tpu_torch.dispatch import dispatch_history
    from triple_accel_tpu_torch.levenshtein import (
        levenshtein_search_simd_with_opts)
    from triple_accel_tpu_torch.ops import search_diag as sd
    from triple_accel_tpu_torch.ops.search_common import window_span
    from triple_accel_tpu_torch.types import EditCosts, SearchType
    from triple_accel_tpu_torch.utils.native import (
        search_all_native, search_intervals_native)

    check(native_loaded, "the general-cost phases need the compiled "
                         "comparators of native/")
    t_phase = time.perf_counter()
    n, m, k = len(hay), NEEDLE_LEN, K_GENERAL
    dispatch_history(clear=True)
    sd.search_diag.launches = 0  # 0 just before the path ...
    results, e2e = {}, {}
    for c in GENERAL_COSTS:
        for st in (SearchType.Best, SearchType.All):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            results[(c, st)] = levenshtein_search_simd_with_opts(
                needle, hay, k, st, EditCosts(*c), False)
            torch.cuda.synchronize()
            e2e[f"{c}_{st.name}"] = time.perf_counter() - t0
    # anchored at a planted copy: the haystack from its first byte on
    anch_costs = EditCosts(*GENERAL_COSTS[0])
    anch_hay = hay[int(planted_alone(planted)[0]):]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    anchored = levenshtein_search_simd_with_opts(
        needle, anch_hay, k, SearchType.All, anch_costs, True)
    torch.cuda.synchronize()
    e2e["anchored_All"] = time.perf_counter() - t0
    launches = sd.search_diag.launches  # ... read just after it
    paths = [d.path for _, d in dispatch_history()]
    check(launches == 5, f"5 general-cost searches launched {launches}")
    check(paths == ["search_diag"] * 5, f"general-cost search took {paths}")

    for c in GENERAL_COSTS:
        costs = EditCosts(*c)
        span = window_span(m, k, costs.gap_cost, costs.start_gap_cost)
        free = copy_free_start(planted, m, span, n, GENERAL_COPY_FREE)
        starts, ends = copy_windows(planted, m, span, n, free,
                                    GENERAL_COPY_FREE)
        ref = search_intervals_native(needle, hay, starts, ends, k, costs)
        all_m = results[(c, SearchType.All)]
        check_all_mode(f"search_general {c}", all_m, ref)
        found = {mt.end for mt in all_m}
        alone = planted_alone(planted)
        check(all(p + m in found or any(abs(e - p - m) <= span
                                        for e in found) for p in alone),
              f"search_general {c}: a planted copy was not found")
        check_best_mode(f"search_general {c}",
                        results[(c, SearchType.Best)], all_m)
    ref_a = search_all_native(needle, anch_hay, k, anch_costs, anchored=True)
    check_all_mode("search_general anchored", anchored, ref_a)
    check(bool(anchored), "search_general: the anchored call at a planted "
                          "copy found nothing")

    # kernel only, at the tensors the main path gives it
    from triple_accel_tpu_torch.levenshtein import _costs_tuple

    hay_d = torch.from_numpy(hay).to(dev)
    nd = torch.from_numpy(needle).to(dev)
    times, bounds, plain_ms, worst = {}, {}, {}, 0
    for c in GENERAL_COSTS:
        costs = EditCosts(*c)
        ct = _costs_tuple(costs)
        halo = min(window_span(m, k, costs.gap_cost, costs.start_gap_cost),
                   n)
        own_len = sd.suggest_own_len_diag(n, halo)
        kw = dict(own_len=own_len, halo=halo, costs_t=ct)
        times[c] = time_launches(lambda: sd.search_diag(hay_d, nd, **kw), 5)
        bounds[c] = prof.k7_bound(n, m, bool(ct[4]))
        cut = hay_d[:DIAG_PLAIN_BYTES]
        got = sd.search_diag(cut, nd, **kw)
        ref = None

        def run_plain():
            nonlocal ref
            ref = sd.search_diag_plain(cut, nd, **kw)

        plain_ms[c] = time_once_ms(run_plain)
        err = _search_err(got, ref)
        worst = max(worst, err)
        check(err == 0, f"search_diag != plain at the cut, costs {c}")
    c0, c1 = GENERAL_COSTS
    emit({"phase": "search_general", "haystack_bytes": n, "needle_len": m,
          "k": k, "costs": [list(c) for c in GENERAL_COSTS],
          "planted": N_PLANTED, "own_len": own_len, "map": sd.diag_plan(m),
          "dispatch": "search_diag", "launches": launches,
          "matches": {f"{c}_{st.name}": len(r)
                      for (c, st), r in results.items()},
          "anchored_matches": len(anchored),
          "reference": "ta_search_intervals over the copies' windows and "
                       f"{GENERAL_COPY_FREE} copy-free bytes; ta_search_all "
                       "anchored",
          "e2e_s": {k_: round(v, 4) for k_, v in e2e.items()},
          "GBps_e2e": {k_: round(n / v / 1e9, 3) for k_, v in e2e.items()
                       if not k_.startswith("anchored")},
          "kernel_ms_median_min_max": {
              str(c): [round(x, 4) for x in times[c]] for c in times},
          "plain_cut_bytes": DIAG_PLAIN_BYTES,
          "plain_ms": {str(c): round(v, 1) for c, v in plain_ms.items()},
          "phase_s": round(time.perf_counter() - t_phase, 1)})
    return {
        "name": "search_diag", "route": "cuda",
        "source": "triple_accel_tpu_torch/csrc/search_diag.cu",
        "kernel": "search_diag_kernel<R, *>", "map": sd.diag_plan(m),
        "replaces": "triple_accel_tpu/ops/pallas/search_kernel.py:51",
        "launches": launches, "max_abs_err": worst,
        "ms": times[c0][0], "ms_min": times[c0][1], "ms_max": times[c0][2],
        "plain_ms": plain_ms[c0],
        "plain_shape": f"the haystack's first {DIAG_PLAIN_BYTES} bytes",
        **bounds[c0], "library_ms": None,
        "costs": list(c0), "ms_transpose_costs": times[c1][0],
        "bound_ms_transpose_costs": bounds[c1]["bound_ms"],
    }


def run_flat_search(dev, native_loaded: bool):
    """General-cost search with a long needle (K8): a cut of the
    long-needle haystack with its copies at k = 150 under GENERAL_COSTS,
    Best and All, against the compiled scalar search over the copies'
    windows and a copy-free stretch; then the dense-hit route of unit-cost
    search (the 400-char needle's hits, from K6: K2's route stops short
    of 400 chars, past the host replay budget, their lengths from K8 over
    the hit-bearing segments) against the compiled scalar search."""
    from triple_accel_tpu_torch.dispatch import dispatch_history
    from triple_accel_tpu_torch.levenshtein import (
        _costs_tuple, levenshtein_search_simd_with_opts)
    from triple_accel_tpu_torch.ops import search_flat as sf
    from triple_accel_tpu_torch.ops.search_common import window_span
    from triple_accel_tpu_torch.types import (
        EditCosts, LEVENSHTEIN_COSTS, SearchType)
    from triple_accel_tpu_torch.utils.native import (
        search_all_native, search_intervals_native)

    check(native_loaded, "the general-cost phases need the compiled "
                         "comparators of native/")
    t_phase = t0 = time.perf_counter()
    m, k = LONG_NEEDLE_LEN, K_LONG_NEEDLE
    needle, hay, planted = make_long_haystack(
        FLAT_HAY_MB << 20, m, N_PLANTED_FLAT, LONG_NEEDLE_SUBS, seed=4040)
    gen_s = time.perf_counter() - t0
    n = len(hay)
    dispatch_history(clear=True)
    sf.flat_search.launches = 0  # 0 just before the path ...
    results, e2e = {}, {}
    for c in GENERAL_COSTS:
        for st in (SearchType.Best, SearchType.All):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            results[(c, st)] = levenshtein_search_simd_with_opts(
                needle, hay, k, st, EditCosts(*c), False)
            torch.cuda.synchronize()
            e2e[f"{c}_{st.name}"] = time.perf_counter() - t0
    launches = sf.flat_search.launches  # ... read just after it
    paths = [d.path for _, d in dispatch_history()]
    check(launches == 4, f"4 long-needle general searches launched "
                         f"{launches}")
    check(paths == ["flat_search"] * 4, f"long-needle dispatch took {paths}")

    free = n - FLAT_COPY_FREE  # make_long_haystack's tail holds no copy
    with ThreadPoolExecutor(len(GENERAL_COSTS)) as pool:
        futures = {}
        for c in GENERAL_COSTS:
            costs = EditCosts(*c)
            span = window_span(m, k, costs.gap_cost, costs.start_gap_cost)
            starts, ends = copy_windows(planted, m, span, n, free,
                                        FLAT_COPY_FREE)
            futures[c] = pool.submit(search_intervals_native, needle, hay,
                                     starts, ends, k, costs)
        refs = {c: f.result() for c, f in futures.items()}
    for c in GENERAL_COSTS:
        all_m = results[(c, SearchType.All)]
        check_all_mode(f"flat_search {c}", all_m, refs[c])
        by_end = {mt.end: mt for mt in all_m}
        for pos in planted.tolist():
            mt = by_end.get(pos + m)
            check(mt is not None and mt.k <= LONG_NEEDLE_SUBS * c[0],
                  f"flat_search {c}: planted copy at {pos} not found")
        check_best_mode(f"flat_search {c}", results[(c, SearchType.Best)],
                        all_m)

    # the dense-hit route of unit-cost search
    dn = np.frombuffer(DENSE_NEEDLE, np.uint8)
    dh = np.frombuffer(DENSE_HAY, np.uint8)
    dispatch_history(clear=True)
    sf.flat_search.launches = 0  # 0 just before the path ...
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dense = levenshtein_search_simd_with_opts(dn, dh, K_DENSE,
                                              SearchType.All)
    torch.cuda.synchronize()
    dense_s = time.perf_counter() - t0
    launches_dense = sf.flat_search.launches  # ... read just after it
    dense_paths = [d.path for _, d in dispatch_history()]
    check(dense_paths == ["myers_search_blocked", "flat_resolve"]
          and launches_dense >= 1,
          f"the dense-hit route took {dense_paths}, {launches_dense} "
          "flat_search launches")
    check_all_mode("dense-hit route", dense,
                   search_all_native(dn, dh, K_DENSE, LEVENSHTEIN_COSTS))

    # kernel only, at the tensors the main path gives it
    hay_d = torch.from_numpy(hay).to(dev)
    nd = torch.from_numpy(needle).to(dev)
    times, bounds, owns = {}, {}, {}
    for c in GENERAL_COSTS:
        costs = EditCosts(*c)
        ct = _costs_tuple(costs)
        halo = min(window_span(m, k, costs.gap_cost, costs.start_gap_cost),
                   n)
        # each kernel variant's own launch shape and segments
        owns[c] = sf.suggest_own_len_flat(n, halo, transpose=bool(ct[4]))
        kw = dict(own_len=owns[c], halo=halo, costs_t=ct)
        times[c] = time_launches(lambda: sf.flat_search(hay_d, nd, **kw), 3)
        bounds[c] = prof.k8_bound(n, m, bool(ct[4]))
    c0, c1 = GENERAL_COSTS
    # the plain version over the first segments, at the first costs
    kw["costs_t"] = _costs_tuple(EditCosts(*c0))
    kw["halo"] = min(window_span(m, k, c0[1], c0[2]), n)
    kw["own_len"] = owns[c0]
    segs = torch.arange(FLAT_PLAIN_SEGMENTS, device=dev)
    got = sf.flat_search(hay_d, nd, segments=segs, **kw)
    ref = None

    def run_plain():
        nonlocal ref
        ref = sf.flat_search_plain(hay_d, nd, segments=segs, **kw)

    plain_ms = time_once_ms(run_plain)
    worst = _search_err(got, ref)
    check(worst == 0, "flat_search != plain over the first segments")
    emit({"phase": "flat_search", "haystack_bytes": n,
          "cut": f"{FLAT_HAY_MB} MiB of the long-needle haystack's "
                 f"{FULL_HAY_MB} MiB, for run time",
          "needle_len": m, "k": k, "costs": [list(c) for c in GENERAL_COSTS],
          "planted": N_PLANTED_FLAT, "planted_subs": LONG_NEEDLE_SUBS,
          "own_len": {str(c): o for c, o in owns.items()},
          "segments": {str(c): -(-n // o) for c, o in owns.items()},
          "launch_shape": {str(c): sf.SEARCH_SHAPES[c[3] is not None]
                           for c in GENERAL_COSTS},
          "dispatch": "flat_search", "launches": launches,
          "matches": {f"{c}_{st.name}": len(r)
                      for (c, st), r in results.items()},
          "reference": "ta_search_intervals over the copies' windows and "
                       f"the last {FLAT_COPY_FREE} bytes",
          "datagen_s": round(gen_s, 3),
          "e2e_s": {k_: round(v, 4) for k_, v in e2e.items()},
          "MBps_e2e": {k_: round(n / v / 1e6, 3) for k_, v in e2e.items()},
          "kernel_ms_median_min_max": {
              str(c): [round(x, 4) for x in times[c]] for c in times},
          "dense_route": {"needle_len": len(dn), "haystack_bytes": len(dh),
                          "k": K_DENSE, "dispatch": dense_paths,
                          "launches": launches_dense, "matches": len(dense),
                          "e2e_s": round(dense_s, 4)},
          "plain_segments": FLAT_PLAIN_SEGMENTS,
          "plain_ms": round(plain_ms, 1),
          "phase_s": round(time.perf_counter() - t_phase, 1)})
    return {
        "name": "flat_search", "route": "cuda",
        "source": "triple_accel_tpu_torch/csrc/search_flat.cu",
        "kernel": "flat_kernel<true, *>",
        "replaces": "triple_accel_tpu/ops/pallas/search_flat.py:73",
        "launches": launches, "launches_flat_resolve": launches_dense,
        "max_abs_err": worst,
        "ms": times[c0][0], "ms_min": times[c0][1], "ms_max": times[c0][2],
        "plain_ms": plain_ms,
        "plain_shape": f"the first {FLAT_PLAIN_SEGMENTS} segments",
        **bounds[c0], "library_ms": None,
        "costs": list(c0), "ms_transpose_costs": times[c1][0],
        "bound_ms_transpose_costs": bounds[c1]["bound_ms"],
    }


def run_flat_distance(dev, pairs, gen_s: float, native_loaded: bool):
    """General-cost distance past the band plan (K9): long ACGT pairs with
    10% edits at an unbounded threshold under affine costs, so the band is
    the whole length; against the compiled scalar distance on a sample.
    `pairs` and `gen_s` come from `flat_distance_pairs`."""
    from triple_accel_tpu_torch.dispatch import dispatch_history
    from triple_accel_tpu_torch.levenshtein import (
        _costs_tuple, levenshtein_k_batch)
    from triple_accel_tpu_torch.ops import search_flat as sf
    from triple_accel_tpu_torch.types import EditCosts
    from triple_accel_tpu_torch.utils.native import (
        scalar_banded_batch_native)

    check(native_loaded, "the general-cost phases need the compiled "
                         "comparators of native/")
    t_phase = time.perf_counter()
    a_list, b_list = pairs
    n_pairs = len(a_list)
    costs = EditCosts(*AFFINE)
    ct = _costs_tuple(costs)
    dispatch_history(clear=True)
    sf.flat_distance.launches = 0  # 0 just before the path ...
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = levenshtein_k_batch(a_list, b_list, U32_MAX, costs)
    torch.cuda.synchronize()
    e2e = time.perf_counter() - t0
    launches = sf.flat_distance.launches  # ... read just after it
    decisions = [d for _, d in dispatch_history()]
    check(launches >= 1 and [d.path for d in decisions] == ["flat_distance"],
          f"the long general-cost batch took "
          f"{[d.path for d in decisions]}, {launches} launches")
    uk = decisions[0].unit_k
    check(bool((out >= 0).all()), "an unbounded threshold left -1")
    sample = np.random.default_rng(5151).choice(n_pairs, FLAT_DIST_SAMPLE,
                                                replace=False)
    with ThreadPoolExecutor(4) as pool:
        parts = list(pool.map(
            lambda p: scalar_banded_batch_native([a_list[p]], [b_list[p]],
                                                 U32_MAX, costs)[0],
            sample.tolist()))
    check(out[sample].tolist() == parts,
          f"flat_distance != the compiled scalar distance on {sample}")

    # kernel only, at the tensors the main path gives it (m <= n)
    swapped = [(a, b) if len(a) <= len(b) else (b, a)
               for a, b in zip(a_list, b_list)]
    sa, sb = [x for x, _ in swapped], [y for _, y in swapped]
    t = sf.prepare_flat_distance_inputs(sa, sb, device=dev)
    times = time_launches(lambda: sf.flat_distance(*t, costs_t=ct,
                                                   unit_k=uk), 3)
    m_arr = np.array([len(x) for x in sa], np.int64)
    n_arr = np.array([len(y) for y in sb], np.int64)
    bound = prof.k9_bound(m_arr, n_arr, uk, ct)
    cut = sf.prepare_flat_distance_inputs(
        [x[:FLAT_DIST_PLAIN_LEN] for x in sa[:FLAT_DIST_PLAIN_PAIRS]],
        [y[:FLAT_DIST_PLAIN_LEN] for y in sb[:FLAT_DIST_PLAIN_PAIRS]],
        device=dev)
    got = sf.flat_distance(*cut, costs_t=ct, unit_k=uk)
    ref = None

    def run_plain():
        nonlocal ref
        ref = sf.flat_distance_plain(*cut, costs_t=ct, unit_k=uk)

    plain_ms = time_once_ms(run_plain)
    worst = int((got.to(torch.int64) - ref.to(torch.int64)).abs().max())
    check(worst == 0, "flat_distance != plain at the cut")
    emit({"phase": "flat_distance", "pairs": n_pairs,
          "str_len": FLAT_DIST_LEN, "edit_share": FLAT_DIST_EDIT_SHARE,
          "costs": list(AFFINE), "k": U32_MAX, "unit_k": uk,
          "dispatch": "flat_distance", "launches": launches,
          "reference": f"ta_scalar_banded_batch on {FLAT_DIST_SAMPLE} "
                       "sampled pairs",
          "datagen_s": round(gen_s, 3), "e2e_s": round(e2e, 4),
          "pairs_per_s_e2e": round(n_pairs / e2e, 1),
          "kernel_ms_median_min_max": [round(x, 4) for x in times],
          "cells_per_s_kernel": round(bound["cells"]
                                      / (times[0] * 1e-3), 1),
          "plain_cut": [FLAT_DIST_PLAIN_PAIRS, FLAT_DIST_PLAIN_LEN],
          "plain_ms": round(plain_ms, 1),
          "phase_s": round(time.perf_counter() - t_phase, 1)})
    return {
        "name": "flat_distance", "route": "cuda",
        "source": "triple_accel_tpu_torch/csrc/search_flat.cu",
        "kernel": "flat_kernel<false, *>",
        "replaces": "triple_accel_tpu/ops/pallas/search_flat.py:528",
        "launches": launches, "max_abs_err": worst,
        "ms": times[0], "ms_min": times[1], "ms_max": times[2],
        "plain_ms": plain_ms,
        "plain_shape": f"the first {FLAT_DIST_PLAIN_PAIRS} pairs cut to "
                       f"{FLAT_DIST_PLAIN_LEN} bytes",
        **bound, "library_ms": None,
    }


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
    # past the band plan, and past the 1280-char needles of the Myers
    # search kernel: the blocked kernel, against the compiled comparators
    from triple_accel_tpu_torch.ops import myers_chunked as mc
    from triple_accel_tpu_torch.utils.native import (
        myers_distance_batch_native, scalar_banded_batch_native,
        search_all_native)

    (la,), (lb,) = make_long_pairs(1, FRONT_DOOR_LEN, 0.01, seed=50)
    (lb_sw,) = swap_adjacent_list([lb], 0.002, np.random.default_rng(51))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    d = tt.levenshtein(la, lb)
    long_pair_s = time.perf_counter() - t0
    # one pair is one warp on one SM: its kernel alone
    a1, b1 = (la, lb) if len(la) <= len(lb) else (lb, la)
    t = mc.prepare_blocked_distance_inputs([a1], [b1], device=dev)
    long_pair_ms = time_launches(lambda: mc.blocked_distance(*t), 3)
    check(d == int(myers_distance_batch_native([la], [lb], U32_MAX)[0]),
          f"levenshtein on {FRONT_DOOR_LEN} bytes gave {d}")
    d_unit = int(myers_distance_batch_native([la], [lb_sw], U32_MAX)[0])
    d_r = tt.rdamerau(la, lb_sw)
    check(d_r == int(scalar_banded_batch_native(
        [la], [lb_sw], d_unit, tt.RDAMERAU_COSTS)[0]) and d_r < d_unit,
          f"rdamerau on {FRONT_DOOR_LEN} bytes gave {d_r}")
    needle, hay, _ = make_long_haystack(COPY_FREE_BYTES + 40_000,
                                        FRONT_DOOR_NEEDLE, 1, 20, seed=52)
    hay = hay[:40_000]  # one copy, at 0
    found = tt.levenshtein_search(needle, hay)
    ends, ks, lens = search_all_native(needle, hay, FRONT_DOOR_NEEDLE // 2,
                                       tt.LEVENSHTEIN_COSTS)
    ref = {e: (e - ln, kk) for e, kk, ln in zip(ends.tolist(), ks.tolist(),
                                                lens.tolist())}
    check(found and found[0].start == 0 and found[0].k <= 20
          and all(ref.get(mt.end) == (mt.start, mt.k)
                  and mt.k == min(ks.tolist()) for mt in found),
          f"levenshtein_search with a {FRONT_DOOR_NEEDLE}-byte needle gave "
          f"{found[:3]}")
    # general costs: a short search, and a pair past the band plan
    aff = tt.EditCosts(*AFFINE)
    got = levenshtein_search_simd_with_opts(b"helllo", b"say hello world", 4,
                                            tt.SearchType.All, aff)
    from triple_accel_tpu_torch.oracle import (
        levenshtein_search_naive_with_opts)
    check(got == levenshtein_search_naive_with_opts(
        b"helllo", b"say hello world", 4, tt.SearchType.All, aff),
          f"general-cost search gave {got}")
    (ga,), (gb,) = make_long_pairs(1, FRONT_DOOR_GENERAL_LEN, 0.05, seed=53)
    got_g = levenshtein_simd_k_with_opts(ga, gb, U32_MAX, False, aff)
    exp_g = int(scalar_banded_batch_native([ga], [gb], U32_MAX, aff)[0])
    check(got_g == (exp_g, None),
          f"general-cost distance on {FRONT_DOOR_GENERAL_LEN} bytes gave "
          f"{got_g}, the compiled scalar distance {exp_g}")
    probes = 0
    for fn, exc in (
        (lambda: tt.EditCosts(0, 1, 0, None), ValueError),
        (lambda: levenshtein_search_simd_with_opts(
            b"ab", b"abc", 1, tt.SearchType.Best, tt.EditCosts(1, 1, 0, 3)),
         ValueError),
        (lambda: tt.levenshtein_k_batch([b"a"], [], 1), ValueError),
        (lambda: tt.hamming(b"abcd", b"abc"), ValueError),
        # a mesh that is not a parallel.Mesh, one that mixes the CPU and
        # the card, and a device= that is not the mesh's first device
        (lambda: tt.levenshtein_k_batch([b"ab"], [b"ba"], 1, mesh=object()),
         TypeError),
        (lambda: tt.parallel.make_mesh(["cpu", dev]), ValueError),
        (lambda: tt.hamming_search_sharded(b"ab", b"abab", 1,
                                           tt.parallel.make_mesh(),
                                           device="cpu"), ValueError),
    ):
        try:
            fn()
        except exc:
            probes += 1
        else:
            raise RuntimeError("a misuse probe raised nothing")
    emit({"phase": "front_door", "parity_calls": 14, "misuse_probes": probes,
          "levenshtein_long_pair": {
              "str_len": FRONT_DOOR_LEN, "distance": d,
              "e2e_s": round(long_pair_s, 4),
              "kernel_ms_median_min_max": [round(x, 4)
                                           for x in long_pair_ms]}})


def run_ir() -> None:
    """`utils/inspect_ir.py` on the build at hand: K1's PTX and SASS, both
    non-empty and naming the kernel, and the assembler's registers, stack
    frame and spill bytes of every kernel's instantiations."""
    from triple_accel_tpu_torch.utils import build, inspect_ir

    t0 = time.perf_counter()
    name = "myers_distance_kernel"
    ptx = inspect_ir.dump_lowered(name)
    sass = inspect_ir.dump_lowered(name, compiled=True)
    check(".entry" in ptx and name in ptx, "the PTX does not name K1")
    n_sass = len(re.findall(r"/\*[0-9a-f]{4,}\*/\s+\S", sass))
    check(n_sass > 0 and name in sass, "the SASS does not name K1")
    resources = {
        name: [r.get(k_) for k_ in ("registers", "stack_frame_bytes",
                                    "spill_store_bytes", "spill_load_bytes")]
        for name, r in inspect_ir.resources_by_kernel(
            build.build_info()["compiler_output"]).items()}
    for label, names in inspect_ir.KERNELS.items():
        check(all(any(k_.startswith(n + "<") or k_ == n for k_ in resources)
                  for n in names), f"{label}: no resource lines")
    emit({"phase": "ir", "kernel": name, "ptx_lines": ptx.count("\n"),
          "sass_instructions": n_sass,
          "resources_note": "registers, stack frame, spill store and spill "
                            "load bytes of each instantiation (-Xptxas -v)",
          "resources": resources,
          "seconds": round(time.perf_counter() - t0, 1)})


def run_profile(dev, a_list, b_list, k1_out) -> None:
    """One `levenshtein_k_batch` call of the `distance` phase's shape under
    `utils.profiling.trace`: the Chrome trace must hold K1's kernel as a
    CUDA event; its five device operations that took most time."""
    import tempfile

    import triple_accel_tpu_torch as tt

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        with prof.trace("levenshtein_k_batch", tmp):
            out = tt.levenshtein_k_batch(a_list, b_list, K_DIST, device=dev)
        seconds = time.perf_counter() - t0
        files = os.listdir(tmp)
        check(len(files) == 1, f"trace files: {files}")
        path = os.path.join(tmp, files[0])
        trace_mb = os.path.getsize(path) / 2**20
        ops = prof.device_time_by_name(path)
    check(np.array_equal(out, k1_out), "profiled call != distance phase")
    k1_us = sum(v for n, v in ops.items() if "myers_distance_kernel" in n)
    check(k1_us > 0, "the trace holds no myers_distance_kernel CUDA event")
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:5]
    emit({"phase": "profile", "pairs": len(a_list),
          "call_and_trace_s": round(seconds, 3),
          "trace_MB": round(trace_mb, 2), "device_ops": len(ops),
          "myers_distance_kernel_us": round(k1_us, 1),
          "top5_device_us": [[n, round(v, 1)] for n, v in top]})


def run_fuzz(dev) -> None:
    """`benches/gpu_fuzz.py` at full size on the card: every section, 0
    mismatches and every engine of the ladder reached; each kernel's
    launches in the run."""
    from triple_accel_tpu_torch.benches import gpu_fuzz
    from triple_accel_tpu_torch.ops import lev_band as lb
    from triple_accel_tpu_torch.ops import trace_walk as tw

    kernels = {**mesh_kernels(), "band_trace": lb.band_trace,
               "trace_walk": tw.trace_walk}
    for fn in kernels.values():
        fn.launches = 0  # 0 just before the fuzz ...
    res = gpu_fuzz.run(dev)
    launches = {n: fn.launches for n, fn in kernels.items()}  # ... after
    missing = sorted(gpu_fuzz.LADDER - set(res["engines_reached"]))
    emit({"phase": "fuzz", "cases": res["cases"],
          "mismatches": res["mismatches"],
          "sections": len(res["sections"]),
          "engines_reached": res["engines_reached"],
          "engines_missing": missing, "launches": launches,
          "seconds": res["seconds"]})
    check(res["mismatches"] == 0, f"fuzz: {res['mismatches']} mismatches")
    check(not missing, f"fuzz: engines not reached: {missing}")
    check(all(launches.values()), f"fuzz: kernels not launched: {launches}")


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
    run_ir()

    # 3. kernels against their plain versions, on the card
    t0 = time.perf_counter()
    d_cases, d_err = check_distance_kernel(dev)
    s_cases, s_err, edge_plan = check_search_kernel(dev)
    b_cases, b_err = check_band_kernels(dev)
    c_cases, c_err = check_band_cluster(dev)
    w_cases, w_err = check_trace_walk_kernel(dev)
    (bd_cases, bd_err), (bs_cases, bs_err) = check_blocked_kernels(dev)
    sd_cases, sd_err = check_search_diag_kernel(dev)
    fs_cases, fs_err = check_flat_search_kernel(dev)
    fd_cases, fd_err = check_flat_distance_kernel(dev)
    emit({"phase": "kernel_checks", "tolerance": "exact (integers)",
          "myers_distance": {"cases": d_cases, "max_abs_err": d_err},
          "myers_search": {"cases": s_cases, "max_abs_err": s_err,
                           "dictionary_launch_needles": DICT_CHECK_NUM,
                           "nonzero_edge": {
                               "needles": DICT_EDGE[0],
                               "haystack_bytes": DICT_EDGE[1],
                               "needle_len": DICT_EDGE[2],
                               "launches": edge_plan}},
          "band_distance_and_band_trace": {
              "cases_short": b_cases["short"], "cases_long": b_cases["long"],
              "cases_wide": b_cases["wide"],
              "cases_block_edges": b_cases["block_edges"],
              "cases_lane_edges": b_cases["lane_edges"],
              "max_abs_err": b_err},
          "band_trace_cluster": {"cases": c_cases, "max_abs_err": c_err},
          "trace_walk": {"cases": w_cases, "max_abs_err": w_err},
          "blocked_distance": {"cases": bd_cases, "max_abs_err": bd_err},
          "blocked_search": {"cases": bs_cases, "max_abs_err": bs_err},
          "search_diag": {"cases": sd_cases, "max_abs_err": sd_err},
          "flat_search": {"cases": fs_cases, "max_abs_err": fs_err},
          "flat_distance": {"cases": fd_cases, "max_abs_err": fd_err},
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
    k2, mono, mono_e2e = run_search(dev, needle, hay, planted, gen_s,
                                    native_loaded)
    k2.update(cases=s_cases, ok=True)

    # dictionary search over one resident haystack, and the resumable
    # sweep over the search phase's input
    dict_launches = run_dictionary(dev, hay_mb, native_loaded)
    k2["launches_dictionary"] = dict_launches["myers_search"]
    run_sweep(dev, needle, hay, mono, mono_e2e)

    # every mesh= route, on the card's mesh and on shards of one card;
    # the long-pair phases' inputs are made here, once, for both
    pairs5, gen5 = blocked_pairs(scale)
    pairs9, gen9 = flat_distance_pairs(scale)
    mesh_launches = run_mesh(dev, a_list, b_list, k1_out, needle, hay, mono,
                             dict_launches, pairs5, pairs9)
    del dict_launches["hay"], dict_launches["short"]

    # 6, 7. general costs, long strings, tracebacks
    b_rows = np.stack(b_list)
    swap_adjacent(b_rows, SWAPS_PER_PAIR, np.random.default_rng(4321))
    b_swapped = list(b_rows)
    k3, k3_long = run_band_distance(dev, a_list, b_swapped,
                                    (a_list, b_list), k1_out, native_loaded,
                                    scale)
    k4, k10, k4_long, k10_long = run_band_trace(dev, a_list, b_swapped,
                                                scale)
    k4_past, k10_past = run_band_trace_past_plan(dev, scale, native_loaded)
    wide = run_band_wide(dev, scale, native_loaded)
    for entry in wide:
        entry.update(ok=True, cases=(
            w_cases if entry["name"].startswith("trace_walk")
            else c_cases if entry["regime"] == "wide_cluster"
            else (b_cases["wide"] + b_cases["block_edges"]) // 2))
    for entry, regime in ((k3, "short"), (k3_long, "long"), (k4, "short"),
                          (k4_long, "long")):
        entry.update(cases=b_cases[regime] // 2, ok=True)
    k4_past.update(cases=c_cases, ok=True)
    for entry in (k10, k10_long, k10_past):
        entry.update(cases=w_cases, ok=True)

    # 8. Hamming (plain ops)
    run_hamming(dev, a_list, b_list, needle, hay, planted)

    # 9, 10. unbounded lengths and long needles
    k5 = run_blocked_distance(dev, pairs5, gen5, native_loaded)
    k5.update(cases=bd_cases, ok=True)
    k6, k6_chunked = run_blocked_search(dev, hay_mb, native_loaded)
    k6["launches_dictionary"] = dict_launches["blocked_search"]
    for entry in (k6, k6_chunked):
        entry.update(cases=bs_cases, ok=True)

    # 11, 12, 13. general costs: search with short and long needles and
    # the dense-hit route, distance past the band plan
    k7 = run_search_general(dev, needle, hay, planted, native_loaded)
    k7["launches_dictionary"] = dict_launches["search_diag"]
    k7.update(cases=sd_cases, ok=True)
    k8 = run_flat_search(dev, native_loaded)
    k8.update(cases=fs_cases, ok=True)
    k9 = run_flat_distance(dev, pairs9, gen9, native_loaded)
    k9.update(cases=fd_cases, ok=True)

    # 14. front door
    front_door(dev)

    # 15, 16. the distance call under the profiler; the differential fuzz
    run_profile(dev, a_list, b_list, k1_out)
    run_fuzz(dev)

    emit({"phase": "done",
          "seconds": round(time.perf_counter() - t_start, 1),
          # the dictionary phase restarts the card's peak count
          "peak_device_MB": round(max(
              dict_launches["prior_peak"],
              torch.cuda.max_memory_allocated()) / 2**20)})
    for entry, name in ((k1, "myers_distance"), (k2, "myers_search"),
                        (k3, "band_distance"), (k5, "blocked_distance"),
                        (k6, "blocked_search"), (k7, "search_diag"),
                        (k8, "flat_search"), (k9, "flat_distance")):
        entry["launches_mesh"] = mesh_launches[name]
    emit({"kernels": [k1, k2, k3, k3_long, k4, k4_long, k4_past, k10,
                      k10_long, k10_past, *wide, k5, k6, k6_chunked, k7, k8,
                      k9]})
    print(smi_line(), flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
