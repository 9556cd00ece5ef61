"""Tracing, throughput metrics and the H100 cost model of every kernel.

Own counterpart, for the PyTorch/CUDA port, of the JAX package's
`utils/profiling.py`, under the same public names:

* `trace(...)`: context manager around `torch.profiler` so any region can
  be captured as a Chrome trace (`TRIPLE_ACCEL_TORCH_TRACE_DIR` or the
  argument); it records the card's activity whenever there is a card;
* `Throughput`: the pairs/s and bytes/s reporter;
* the cost model: the least time one H100 could take for each kernel's
  work (K1 to K10), the larger of the bytes it must move over the card's
  memory rate and the 32-bit integer operations its function needs over
  the card's integer rate.  `chip_smoke.py` prints these beside every
  kernel's time; `kernel_cost_estimate`, `distance_kernel_cost_estimate`
  and `search_kernel_cost_estimate` are the JAX names over them, with the
  JAX functions' keys.

The counts are of the FUNCTION each kernel computes, at the card's best
(the comments above each constant list the operations), not of the
kernel's own instructions, so a later kernel of the same function is
judged against the same roofline.  Nothing here imports a kernel's
library or needs a card.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import re
import time
from dataclasses import dataclass, field
from typing import Dict, Iterator, Optional

import numpy as np
import torch

__all__ = [
    "trace",
    "device_time_by_name",
    "Throughput",
    "kernel_cost_estimate",
    "distance_kernel_cost_estimate",
    "search_kernel_cost_estimate",
    "CARD",
    "PEAK_BYTES_PER_S",
    "PEAK_INT32_OPS_PER_S",
    "roofline",
    "k1_bound",
    "k2_bound",
    "band_valid_cells",
    "band_bound",
    "k3_bound",
    "k4_bound",
    "k5_bound",
    "k6_bound",
    "search_lengths_bound",
    "k7_bound",
    "k8_bound",
    "k9_bound",
    "walk_lengths",
    "k10_bound",
]


# ---------------------------------------------------------------------------
# trace and throughput
# ---------------------------------------------------------------------------

_TRACE_SEQ = itertools.count()


@contextlib.contextmanager
def trace(name: str, trace_dir: Optional[str] = None) -> Iterator[None]:
    """Capture a `torch.profiler` trace of the wrapped region when a trace
    dir is configured (arg or TRIPLE_ACCEL_TORCH_TRACE_DIR); no-op
    otherwise.

    The region runs inside `record_function(name)`, and the trace is
    written to `trace_dir` as a Chrome trace (`<name>.<pid>.<n>.json`).
    With a card present the card's activity is recorded too; a small probe
    launch at the region's end must show up as a CUDA event, else this
    raises `RuntimeError` (the profiler could not record the card, e.g.
    no CUPTI): a trace that silently holds the host alone is refused."""
    trace_dir = trace_dir or os.environ.get("TRIPLE_ACCEL_TORCH_TRACE_DIR")
    if not trace_dir:
        yield
        return
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        with record_function(name):
            yield
        if cuda:
            torch.ones(1, device="cuda").add_(1)  # the probe
            torch.cuda.synchronize()
    if cuda and not any(e.device_type == DeviceType.CUDA
                        for e in prof.events()):
        raise RuntimeError(
            "torch.profiler recorded no CUDA activity although a card is "
            "present (CUPTI unavailable?); refusing a host-only trace")
    safe = re.sub(r"[^A-Za-z0-9_.-]+", "_", name) or "trace"
    prof.export_chrome_trace(os.path.join(
        trace_dir, f"{safe}.{os.getpid()}.{next(_TRACE_SEQ)}.json"))


def device_time_by_name(path: str) -> Dict[str, float]:
    """Device time (microseconds) summed by name over the card's events of
    a Chrome trace that `trace` wrote: kernels, copies and memsets."""
    with open(path) as fh:
        events = json.load(fh).get("traceEvents", [])
    out: Dict[str, float] = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in (
                "kernel", "gpu_memcpy", "gpu_memset"):
            out[e["name"]] = out.get(e["name"], 0.0) + float(e.get("dur", 0))
    return out


@dataclass
class Throughput:
    """Accumulates work items and wall time; reports rates.

    >>> t = Throughput()
    >>> with t.measure(pairs=10, bytes_processed=1000):
    ...     pass
    >>> t.pairs >= 10
    True
    """

    pairs: int = 0
    bytes_processed: int = 0
    seconds: float = 0.0
    extra: Dict[str, float] = field(default_factory=dict)

    @contextlib.contextmanager
    def measure(self, pairs: int = 0, bytes_processed: int = 0):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.seconds += time.perf_counter() - t0
            self.pairs += pairs
            self.bytes_processed += bytes_processed

    @property
    def pairs_per_sec(self) -> float:
        return self.pairs / self.seconds if self.seconds else 0.0

    @property
    def bytes_per_sec(self) -> float:
        return self.bytes_processed / self.seconds if self.seconds else 0.0

    def report(self) -> Dict[str, float]:
        out = {
            "pairs_per_sec": self.pairs_per_sec,
            "bytes_per_sec": self.bytes_per_sec,
            "seconds": self.seconds,
        }
        out.update(self.extra)
        return out


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------

# Peak rates of one NVIDIA H100 80GB HBM3 (SXM) at its full power limit of
# 700 W (NVIDIA's data sheet): 3.35 TB/s of HBM, and 67 TFLOP/s of float32
# outside the tensor cores = 128 lanes x 2 (FMA) per SM and clock; an SM
# has half as many 32-bit integer lanes and an integer instruction counts
# once, so 67 / 4 = 16.75 T 32-bit integer operations a second.  A card
# set below 700 W runs slower under load: a roofline share is stated
# against these peaks with the card's power limit beside it.
CARD = "NVIDIA H100 80GB HBM3, 700 W"
PEAK_BYTES_PER_S = 3.35e12
PEAK_INT32_OPS_PER_S = 67e12 / 4

# ---------------------------------------------------------------------------
# operation counts of each kernel's function
# ---------------------------------------------------------------------------

# 32-bit integer operations the two Myers functions need, counted as the
# card would issue them at its best: one instruction for any logic
# function of three inputs, one for a funnel shift across two registers,
# an add with carry in one instruction, and the narrowest 32-bit word count
# that holds the band (K1) or the needle (K2).  None of the kernel's own
# overhead (ring upkeep, rotates, byte extraction, 64-bit words) is in here.
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
# K5, the blocked distance, per column and 32 needle bits: K2's recurrence
# (K2_OPS_PER_COL_WORD32: 11, 15 with the restricted-Damerau seeds) over
# the pair's whole needle; per column besides, 3: the score's two bit picks
# and one 3-input add.  No emit: the score is read once, at the pair's n.
K5_OPS_PER_COL_WORD32 = K2_OPS_PER_COL_WORD32
K5_OPS_PER_COL = 3
# K6, the blocked search, computes K2's function for any needle length:
# K2's counts, over ceil(m / 32) words, for every column of the haystack
# once (a segment's halo re-read is the kernel's overhead, not the
# function's).
K6_OPS_PER_COL_WORD32 = K2_OPS_PER_COL_WORD32
K6_OPS_PER_COL = K2_OPS_PER_COL
# K7, general-cost search with match lengths, per DP cell (a needle row at
# a haystack column), counted for the scalar core's column recurrence at
# the card's best, with Hopper's fused add-min as one: the horizontal
# chain's cost as an add and a fused add-min (2) and its length as a
# compare, a max for the tie, a select and the add of one (4); the vertical
# chain the same without that add (5); the substitution's character
# compare, the predicated add of the mismatch cost and its length's add
# (3); the cascade's two replacements, each a compare of costs, a compare
# of lengths, their combination and two selects (10): 24.  With
# transposition 6 more: two character compares (2), the add of its cost
# (1), the <= (1) and two selects (2).  The halo a segment re-reads is the
# kernel's overhead, not the function's.
K7_OPS_PER_CELL = 24
K7_OPS_TRANSPOSE = 6
# K8 computes K7's function for needles of any length: K7's counts (its
# row-wise prefix scan is the kernel's way, not the function's).
K8_OPS_PER_CELL = K7_OPS_PER_CELL
K8_OPS_TRANSPOSE = K7_OPS_TRANSPOSE
# K9 computes K3's function, the general-cost distance without lengths,
# over the cells of its band: K3's counts (BAND_OPS_*), through band_bound.
K9_OPS_PER_CELL = BAND_OPS_PER_CELL
K9_OPS_TRANSPOSE = BAND_OPS_TRANSPOSE
# K10, the traceback walk, per step of a walk: one 32-bit code word and, on
# a diagonal step, a's and b's characters (6 bytes at most); per run of
# equal steps one 32-bit word written, per pair m and n read and its run
# count written; a handful of integer operations a step, so bytes bound
# it.  Its steps depend on each other: `chip_smoke.py` times the batch's
# longest walk alone beside the bound.
K10_CODE_BYTES, K10_CHAR_BYTES, K10_RUN_BYTES = 4, 2, 4
K10_OPS_PER_STEP = 12


# ---------------------------------------------------------------------------
# the bound of each kernel
# ---------------------------------------------------------------------------

def roofline(bytes_moved: int, ops: int) -> dict:
    """The least time the card could take to move `bytes_moved` bytes and
    issue `ops` 32-bit integer operations: {"bound_ms", "bound_by"
    ("bytes" or "operations"), "bound_bytes_ms", "bound_operations_ms"}."""
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_INT32_OPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_bytes_ms": t_bytes, "bound_operations_ms": t_ops}


def _myers_words(k: int) -> int:
    """The 64-bit words K1 keeps a pair's band in at threshold k
    (ops/myers_distance.py `myers_plan`); 0 past its three words."""
    from ..ops.myers_distance import myers_plan

    plan = myers_plan(k)
    return plan[0] if plan else 0


def k1_bound(m_arr: np.ndarray, k: int) -> dict:
    """K1 (`myers_distance`) on pairs whose shorter strings have lengths
    `m_arr`, at threshold `k`: each pair's two strings over its m rows and
    window padding (the plan's 64 bits a word) read once, 16 bytes of
    lengths, thresholds and the distance a pair; K1_OPS_* a row over the
    32-bit words that hold the k + 1 band."""
    m_arr = np.asarray(m_arr, np.int64)
    wp = 64 * _myers_words(k)
    bytes_moved = int((2 * m_arr + wp).sum()) + 16 * m_arr.size
    band_words32 = -(-(k + 1) // 32)
    ops = int(m_arr.sum()) * (K1_OPS_PER_ROW_WORD32 * band_words32
                              + K1_OPS_PER_ROW)
    return roofline(bytes_moved, ops)


def k2_bound(n: int, m: int, damerau: bool) -> dict:
    """K2 (`myers_search`) on one needle of `m` chars over `n` haystack
    bytes: the haystack read once, one int written a column and one for
    the virtual column 0, the needle read; K2_OPS_* a column."""
    ops = n * (K2_OPS_PER_COL_WORD32[damerau] * -(-m // 32) + K2_OPS_PER_COL)
    return roofline(n + 4 * (n + 1) + m, ops)


def band_valid_cells(m_arr: np.ndarray, n_arr: np.ndarray,
                     unit_k: int) -> int:
    """Band cells of rows 1..m that lie inside the DP matrix, summed over
    the pairs: row i holds columns max(0, i - unit_k) .. min(n, i +
    unit_k)."""
    pairs, counts = np.unique(np.stack([m_arr, n_arr], axis=1), axis=0,
                              return_counts=True)
    total = 0
    for (m, n), cnt in zip(pairs.tolist(), counts.tolist()):
        i = np.arange(1, m + 1, dtype=np.int64)
        width = np.minimum(n, i + unit_k) - np.maximum(0, i - unit_k) + 1
        total += cnt * int(np.clip(width, 0, None).sum())
    return total


def band_bound(m_arr, n_arr, unit_k: int, ct, traced: bool) -> dict:
    """The least time the card could take for a band batch: every string
    byte and length read once, every distance (and packed code word of
    rows 1..m) written once, against the operations of the cells inside
    the matrix.  `ct`: the costs tuple (its [4]: transpositions).  Adds
    "cells" and "ops_per_cell" to `roofline`'s keys."""
    from ..ops.band_scan import code_words

    m_arr = np.asarray(m_arr, np.int64)
    n_arr = np.asarray(n_arr, np.int64)
    cells = band_valid_cells(m_arr, n_arr, unit_k)
    per_cell = BAND_OPS_PER_CELL
    if ct[4]:
        per_cell += BAND_OPS_TRANSPOSE
    if traced:
        per_cell += BAND_OPS_CODE[bool(ct[4])]
    bytes_moved = int((m_arr + n_arr).sum()) + 12 * m_arr.size
    if traced:
        bytes_moved += int(m_arr.sum()) * code_words(2 * unit_k + 1) * 4
    return {**roofline(bytes_moved, cells * per_cell),
            "cells": cells, "ops_per_cell": per_cell}


def k3_bound(m_arr, n_arr, unit_k: int, ct) -> dict:
    """K3 (`band_distance`): `band_bound` untraced."""
    return band_bound(m_arr, n_arr, unit_k, ct, False)


def k4_bound(m_arr, n_arr, unit_k: int, ct) -> dict:
    """K4 (`band_trace`): `band_bound` with the argmin codes."""
    return band_bound(m_arr, n_arr, unit_k, ct, True)


def k5_bound(m_arr: np.ndarray, n_arr: np.ndarray, damerau: bool) -> dict:
    """K5 (`blocked_distance`) on these pairs: every byte of both strings
    read, two lengths read and one distance written a pair, against K2's
    recurrence over each pair's needle words at each of its columns
    (K5_OPS_*)."""
    m_arr = np.asarray(m_arr, np.int64)
    n_arr = np.asarray(n_arr, np.int64)
    words32 = -(-m_arr // 32)
    ops = int((n_arr * (words32 * K5_OPS_PER_COL_WORD32[damerau]
                        + K5_OPS_PER_COL)).sum())
    bytes_moved = int(m_arr.sum()) + int(n_arr.sum()) + 12 * m_arr.size
    return roofline(bytes_moved, ops)


def k6_bound(iter_len: int, m: int, damerau: bool) -> dict:
    """K6 (`blocked_search`) on one needle: the haystack read once, one int
    written a column, the needle read; K2's operations a column."""
    ops = iter_len * (-(-m // 32) * K6_OPS_PER_COL_WORD32[damerau]
                      + K6_OPS_PER_COL)
    return roofline(iter_len + 4 * (iter_len + 1) + m, ops)


def search_lengths_bound(positions: int, m: int, transpose: bool,
                         per_cell: int, per_trans: int) -> dict:
    """K7 or K8 on one needle: every haystack byte of `positions` read
    once and a distance and a length written for each, the needle read,
    against the operations of the positions' m cells."""
    ops = positions * m * (per_cell + (per_trans if transpose else 0))
    return roofline(positions + 8 * (positions + 1) + m, ops)


def k7_bound(positions: int, m: int, transpose: bool) -> dict:
    """K7 (`search_diag`): `search_lengths_bound` with K7_OPS_*."""
    return search_lengths_bound(positions, m, transpose, K7_OPS_PER_CELL,
                                K7_OPS_TRANSPOSE)


def k8_bound(positions: int, m: int, transpose: bool) -> dict:
    """K8 (`flat_search`): `search_lengths_bound` with K8_OPS_*."""
    return search_lengths_bound(positions, m, transpose, K8_OPS_PER_CELL,
                                K8_OPS_TRANSPOSE)


def k9_bound(m_arr, n_arr, unit_k: int, ct) -> dict:
    """K9 (`flat_distance`) banded by `unit_k`: K3's function over the
    cells of its band (`band_bound` untraced; K9_OPS_* = BAND_OPS_*)."""
    return band_bound(m_arr, n_arr, unit_k, ct, False)


def walk_lengths(runs: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """Steps each pair walked, from a walk's (runs, counts)."""
    pair = torch.repeat_interleave(
        torch.arange(len(counts), device=counts.device), counts.long())
    return torch.zeros(len(counts), dtype=torch.int64,
                       device=counts.device).index_add_(
        0, pair, (runs >> 3).long())


def k10_bound(runs: torch.Tensor, counts: torch.Tensor, steps: int) -> dict:
    """K10 (`trace_walk`) for the walks of (runs, counts), its output: the
    code words and characters the walked steps read, m and n read, the
    runs and run counts written once, against K10_OPS_PER_STEP operations
    a walked step.  Adds the walked steps, the longest walk, `steps` and
    the runs to `roofline`'s keys."""
    length = (runs >> 3).long()
    diag = ((runs & 7) <= 1).long()
    n_walked, n_diag = int(length.sum()), int((length * diag).sum())
    B = counts.shape[0]
    bytes_moved = (n_walked * K10_CODE_BYTES + n_diag * K10_CHAR_BYTES
                   + runs.numel() * K10_RUN_BYTES + 4 * B + 8 * B)
    longest = int(walk_lengths(runs, counts).max()) if B else 0
    return {**roofline(bytes_moved, n_walked * K10_OPS_PER_STEP),
            "walked_steps": n_walked, "longest_walk": longest,
            "steps": steps, "runs": runs.numel()}


# ---------------------------------------------------------------------------
# the JAX package's names
# ---------------------------------------------------------------------------

def kernel_cost_estimate(
    batch: int,
    rows: int,
    band: int,
    ops_per_cell: int = BAND_OPS_PER_CELL,
    ops_per_sec: float = PEAK_INT32_OPS_PER_S,
) -> Dict[str, float]:
    """Roofline of the general band kernel (K3) on `batch` pairs of `rows`
    rows over a band of `band` cells, every cell counted (as the JAX
    function counts them): the larger of the cells' operations over
    `ops_per_sec` and the strings, lengths and distances over the card's
    memory rate.  Returns the ideal seconds and pairs/s to compare
    measurements against."""
    t_ops = batch * rows * band * ops_per_cell / ops_per_sec
    t_bytes = batch * (2 * rows + 12) / PEAK_BYTES_PER_S
    ideal_seconds = max(t_ops, t_bytes)
    return {
        "ideal_seconds": ideal_seconds,
        "ideal_pairs_per_sec": batch / ideal_seconds if ideal_seconds else 0.0,
    }


def distance_kernel_cost_estimate(k: int, max_m: int) -> Dict[str, float]:
    """Roofline of the Myers distance kernel (K1) at threshold `k` on
    pairs of `max_m` rows: `k1_bound` of one pair, as pairs a second.
    `ops_per_row` is K1_OPS_* over the band's 32-bit words; `pair_blocks`
    (the JAX function's pair blocks of a chain) is K1's 64-bit words a
    pair, `myers_plan`'s NW.  Zeros past K1's threshold cap (k > 191)."""
    nw = _myers_words(k)
    if nw == 0:
        return {"ideal_pairs_per_sec": 0.0, "ops_per_row": 0.0,
                "pair_blocks": 0.0}
    ops_per_row = K1_OPS_PER_ROW_WORD32 * -(-(k + 1) // 32) + K1_OPS_PER_ROW
    bound_s = k1_bound(np.array([max_m]), k)["bound_ms"] * 1e-3
    return {
        "ideal_pairs_per_sec": 1.0 / bound_s if bound_s else 0.0,
        "ops_per_row": float(ops_per_row),
        "pair_blocks": float(nw),
    }


def search_kernel_cost_estimate(needle_len: int,
                                damerau: bool = False) -> Dict[str, float]:
    """Roofline of the Myers search (K2; K6 computes the same function for
    longer needles) on a needle of `needle_len` chars: `k2_bound` of a
    large haystack, as haystack bytes a second.  `subgroups` (the JAX
    function's 128-lane subgroups) is the 32-bit words the needle takes."""
    words = max(-(-needle_len // 32), 1)
    n = 1 << 30
    bound_s = k2_bound(n, needle_len, damerau)["bound_ms"] * 1e-3
    return {"ideal_bytes_per_sec": n / bound_s, "subgroups": float(words)}
