"""The benchmark's frozen cost model: the least time one H100 could take
for the work of the function a call computes.

A frozen copy of the counts and peaks of the port's
`triple_accel_tpu_torch/utils/profiling.py` (as of the benchmark's first
version), so that a later change to the program cannot move the yardstick.
The counts are of the FUNCTION, not of any kernel's instructions: a kernel
that computes the same answers in another way is judged against the same
roofline.  One rule differs from the program's module, on purpose: the
unbounded-threshold distance counts the cells of the band that the pair's
own distance needs (`pairs_bound`), not the full m x n matrix, so that
an adaptive band reads as a gain and never as a share above 100%.

An exact filter that skips DP columns (or rows) changes the function's
work as counted here; a benchmark change has to recount it.

Nothing here imports the program, torch or a card.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "PEAK_BYTES_PER_S",
    "PEAK_INT32_OPS_PER_S",
    "BAND_OPS_PER_CELL",
    "BAND_OPS_TRANSPOSE",
    "SEARCH_LENGTHS_OPS_PER_CELL",
    "SEARCH_LENGTHS_OPS_TRANSPOSE",
    "MYERS_OPS_PER_COL_WORD32",
    "MYERS_OPS_PER_COL",
    "roofline",
    "max_k",
    "unit_k",
    "band_cells",
    "pairs_bound",
    "search_bound",
]

# NVIDIA H100 80GB HBM3 (SXM), NVIDIA's data sheet, at its full power
# limit of 700 W: 3.35 TB/s of HBM.  The 32-bit integer rate is an
# ASSUMPTION, not a data-sheet figure: the float32 rate outside the tensor
# cores (67 TFLOP/s = 128 lanes x 2 per FMA per SM and clock) over 4, since
# an SM has half as many integer lanes and an integer instruction counts
# once: 16.75 T operations a second.  Hopper's fused add-min (DPX) counts
# as one operation.
PEAK_BYTES_PER_S = 3.35e12
PEAK_INT32_OPS_PER_S = 67e12 / 4

# The general-cost distance (the band and row kernels' function), per DP
# cell that lies inside the matrix, at the card's best with INF sentinels
# beside the band: the compare and predicated add of the substitution (2),
# the vertical gap as one fused add-min (2), the min of the two (1), the
# running prefix-min of the horizontal gap (1), the horizontal candidate
# folded into the min (1): 7.  With transpositions 3 more.
BAND_OPS_PER_CELL = 7
BAND_OPS_TRANSPOSE = 3
# General-cost search with match lengths (the diagonal and row search
# kernels' function), per DP cell (a needle row at a haystack column): the
# horizontal chain's cost and length (6), the vertical chain (5), the
# substitution (3), the cascade's two replacements (10): 24.  With
# transpositions 6 more.
SEARCH_LENGTHS_OPS_PER_CELL = 24
SEARCH_LENGTHS_OPS_TRANSPOSE = 6
# Unit-cost (Myers) search, per haystack column and 32 needle bits: the
# Peq lookup, x = Eq & Pv, the add, Xh, Ph, Mh, two shifts, D0, Pv, Mv
# (11); with restricted-Damerau seeds 15.  Per column besides: the score
# kept by the last row's bit and its emission (4).
MYERS_OPS_PER_COL_WORD32 = {False: 11, True: 15}
MYERS_OPS_PER_COL = 4


def roofline(bytes_moved: int, ops: int) -> dict:
    """The least time the card could take to move `bytes_moved` bytes and
    issue `ops` 32-bit integer operations, and which of the two bounds
    it."""
    t_bytes = bytes_moved / PEAK_BYTES_PER_S
    t_ops = ops / PEAK_INT32_OPS_PER_S
    return {"bound_s": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": int(bytes_moved), "ops": int(ops)}


def max_k(la, lb, k: int, costs: dict) -> np.ndarray:
    """The crate's cap of the threshold for pairs of lengths la, lb: no
    distance exceeds "mismatch everything" or "gap everything out and back
    in", plus the gap of the length difference."""
    la = np.asarray(la, np.int64)
    lb = np.asarray(lb, np.int64)
    mc, gc, sgc = (costs["mismatch_cost"], costs["gap_cost"],
                   costs["start_gap_cost"])
    lo, hi = np.minimum(la, lb), np.maximum(la, lb)
    cap = np.minimum(lo * mc, 2 * lo * gc + np.where(
        lo == 0, 0, sgc + np.where(hi == lo, sgc, 0)))
    return np.minimum(k, cap + (hi - lo) * gc + np.where(hi == lo, 0, sgc))


def unit_k(cost, costs: dict) -> np.ndarray:
    """How far from the main diagonal a path of cost `cost` can stray:
    one gap opened, then one extension a diagonal."""
    cost = np.asarray(cost, np.int64)
    return np.maximum(cost - costs["start_gap_cost"], 0) // costs["gap_cost"]


def band_cells(m, n, uk) -> int:
    """DP cells of rows 1..m within |i - j| <= uk that lie inside the
    matrix (0 <= j <= n), summed over the pairs."""
    m = np.asarray(m, np.int64)
    n = np.asarray(n, np.int64)
    uk = np.broadcast_to(np.asarray(uk, np.int64), m.shape)
    total = 0
    for mm, nn, u in zip(m.tolist(), n.tolist(), uk.tolist()):
        i = np.arange(1, mm + 1, dtype=np.int64)
        w = np.minimum(nn, i + u) - np.maximum(0, i - u) + 1
        total += int(np.clip(w, 0, None).sum())
    return total


def pairs_bound(la, lb, k: int, costs: dict, dists=None) -> dict:
    """A distance batch of `levenshtein_k_batch`: every string byte read
    once, two lengths read and a distance written a pair (12 bytes),
    against the operations of the band cells the function needs.  Rows are
    the shorter string's.  A pair whose threshold binds (k under the
    pair's cap): the band of the threshold.  A pair whose threshold does
    not bind, with its distance in `dists`: the band of its own distance,
    the answer's band (without `dists`: the cap's band, the whole
    matrix)."""
    la = np.asarray(la, np.int64)
    lb = np.asarray(lb, np.int64)
    m, n = np.minimum(la, lb), np.maximum(la, lb)
    caps = max_k(la, lb, k, costs)
    need = caps
    if dists is not None:
        # where the threshold does not bind, the answer's band
        free = k >= max_k(la, lb, 1 << 62, costs)
        need = np.where(free, np.asarray(dists, np.int64), caps)
    uk = np.minimum(unit_k(need, costs), n)
    per_cell = BAND_OPS_PER_CELL + (
        BAND_OPS_TRANSPOSE if costs.get("transpose_cost") else 0)
    cells = band_cells(m, n, uk)
    out = roofline(int((la + lb).sum()) + 12 * la.size, cells * per_cell)
    out["cells"] = cells
    return out


def search_bound(hay_bytes: int, needle_lens, costs: dict,
                 unit: bool) -> dict:
    """A dictionary search call over one resident haystack: the haystack
    read once and every needle byte read once, against the operations of
    every needle row at every haystack column, counted once (a segment's
    halo is the kernel's overhead).  `unit`: the Myers function, a 32-bit
    word of needle bits a column; else general costs with match lengths."""
    lens = np.asarray(needle_lens, np.int64)
    n = int(hay_bytes)
    if unit:
        damerau = bool(costs.get("transpose_cost"))
        ops = n * int((MYERS_OPS_PER_COL_WORD32[damerau] * -(-lens // 32)
                       + MYERS_OPS_PER_COL).sum())
    else:
        per_cell = SEARCH_LENGTHS_OPS_PER_CELL + (
            SEARCH_LENGTHS_OPS_TRANSPOSE if costs.get("transpose_cost")
            else 0)
        ops = n * int(lens.sum()) * per_cell
    return roofline(n + int(lens.sum()), ops)
