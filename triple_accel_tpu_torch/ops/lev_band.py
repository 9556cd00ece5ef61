"""Banded general-cost edit distance and traceback codes: kernels K3 and K4.

Counterpart of the JAX package's ops/pallas/lev_band.py.  One module holds
the plan, the host prep, the wrappers of the CUDA kernels
(csrc/band_distance.cu) with their launch counters, the narrow-state rule
`select_band_dtype`, and the bridge from the JAX package's input layout.
The plain PyTorch version of both kernels is ops/band_scan.py
`band_scan_distance`; a wrapper takes it for CPU tensors and for nothing
else.

The function: for every pair (a, b) with len(a) <= len(b) <= len(a) +
unit_k, the edit distance under (mismatch, gap, start_gap, transpose) costs
restricted to the band |j - i| <= unit_k, W = 2*unit_k + 1 cells a row;
`band_trace` also returns the argmin code of every cell of rows 1..m,
{0 sub, 1 consume-b, 2 consume-a, 3 transpose}, which
the traceback walk (ops/trace_walk.py, kernel K10) walks back on the
device.

One kernel source serves the two regimes the TPU split into an untiled and
a row-strip tiled kernel: the strings stream from global memory, so length
is unbounded.  The band bounds the kernel's regime: up to
`MAX_WARP_BAND` cells a group of lanes of one warp holds a pair's band in
registers (`band_plan` picks the cells a lane, the lanes a pair and the
threads a block from the band and the batch); wider bands, up to
`MAX_WIDE_BAND` cells (every untraced band up to `MAX_UNIT_K`), run one
pair a block whose warps hold the band in registers, the same lanes joined
across warps by two slots a warp in shared memory (`BLOCK_CELLS` cells a
lane, `_block_map` picks them and the warps).  Traced
bands past that, up to `MAX_TRACE_UNIT_K`, run one pair a thread-block
cluster with the matrix's columns in registers, in strips of 512 that the
cluster's warps take in a ring, each strip over the rows whose band meets
it (no cell left of column 0 is computed), for b strings of any length.

Layout (the port's own, pair order): `a_t` uint8 [B, max_m], `b_t` uint8
[B, max_m + W] with each pair's b at byte offset unit_k and 0 pads (a pad
may equal a real NUL: validity masks keep that exact), `m`, `n` int32 [B];
codes int32 [B, max_m, ceil(W / 16)], 16 two-bit codes a word.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .band_scan import INF, band_scan_distance, code_words

__all__ = [
    "MAX_UNIT_K",
    "MAX_TRACE_UNIT_K",
    "MAX_WARP_BAND",
    "band_plan",
    "select_band_dtype",
    "prepare_band_tensors",
    "band_distance",
    "band_trace",
    "from_reference_batch",
]

CostsT = Tuple[int, int, int, int, bool]

# what one thread block of an H100 may use (227 KB of the SM's 256 KB)
SMEM_BYTES_PER_BLOCK = 232_448
SM_COUNT = 132  # the H100 SXM's SMs: what "fills the card" is counted in
# The warp regime (csrc/band_distance.cu band_kernel<TRANS, TRACE, C>):
# cells a lane (the kernel's instantiations), lanes a pair (one group of a
# warp), threads a block at most.
WARP_CELLS = (3, 5, 9, 17)
WARP_LANES = (8, 16, 32)
WARP_MAX_THREADS = 256
MAX_WARP_BAND = max(WARP_LANES) * max(WARP_CELLS)  # 544 cells
# The lane map the plan takes, from `benches/band_sweep.py` (NVIDIA H100
# 80GB HBM3, 700 W; PERF.md).  A batch that fills the card takes the
# map with the fewest cells at or above the band (ties: fewer lanes, so
# longer runs a lane) in blocks of FULL_THREADS: band 65, 196,608 pairs:
# 8 lanes x 9 cells 16.89 ms against 22.60 at 16 x 5 and 36.15 at 32 x 3;
# band 513: 32 x 17 at 256 threads 37.55 ms, 39.11 at 128; the threads
# move 0-5% elsewhere.  A batch whose warps at that map stay under
# SMALL_BATCH_WARPS takes 32 lanes a pair and the fewest cells a lane that
# hold the band (the shortest chain a row) in blocks of SMALL_THREADS, so
# that its few warps spread over the SMs: 256 pairs at band 129 (traced)
# 1.79 ms at 32 x 5 and 64 threads, 1.97 at 16 x 9, 2.94 at 8 x 17, 2.20
# at 32 x 5 and 256 threads.
FULL_THREADS = 256
SMALL_THREADS = 64
SMALL_BATCH_WARPS = 4 * SM_COUNT
# The block regime (band_block_kernel<TRANS, TRACE, C, MAXW>): cells a
# lane (the kernel's instantiations) and the most warps a pair of each
# (launch bounds of 16 warps, 128 registers a thread, and for 17 cells
# also 18 warps, 96 registers: 9,792 cells).
BLOCK_CELLS = (9, 17)
BLOCK_MAX_WARPS = {9: 16, 17: 18}
# 9 cells a lane where at most this many warps of them hold the band,
# else 17: a batch that fills the card (index 0) / one of fewer pairs than
# the card has SMs (1).  From `benches/band_sweep.py --wide` (NVIDIA H100
# 80GB HBM3, 700 W; PERF.md), rDamerau, 2,000 rows, ms at 9 / 17
# cells a lane: 1,024 pairs untraced, band 545 1.94 / 3.03 (2 warps
# each: 17 cells leave half their cells past the band), 1,025 3.40 /
# 3.01, 2,049 6.42 / 5.63, 4,097 12.81 / 11.03; 256 traced, 545 1.56 /
# 2.22, 1,025 2.09 / 2.34, 2,049 3.54 / 3.54, 4,097 6.94 / 6.31; one pair
# untraced, 545 0.95 / 1.26, 1,025 0.94 / 1.25, 2,049 1.24 / 1.27 (8 / 4
# warps), 4,097 2.04 / 1.84 (15 / 8: two barriers a row over 15 warps
# cost more than the 8 cells a lane they save); traced 1.58 / 2.22, 1.60
# / 2.27, 2.07 / 2.32, 3.47 / 3.55.
NINE_CELL_WARPS = (2, 8)
# The cluster regime (band_cluster_kernel<TRANS>) takes traced bands up
# to this half-width (csrc/band_distance.cu TA_BAND_MAX_TRACE_UNIT_K); the
# intermediates of its lanes stay in int32 at any band.
MAX_TRACE_UNIT_K = 1 << 20
# One pair a cluster of `ctas` CTAs of `warps` warps, 16 columns a lane, so
# a strip of 512 columns a warp; the kernel's limits (csrc/band_distance.cu
# TA_CL_*): 8 CTAs a cluster (the portable cluster size), 20 warps a CTA
# (its launch bound, 640 threads, holds it to 96 registers a thread: two
# CTAs of 10 warps an SM).  The warps take the strips in a ring, each
# strip only over the rows whose band meets it, so a pair needs as many
# warps as strips meet one row (`_cluster_map`), whatever the length of b.
CLUSTER_COLS_PER_WARP = 32 * 16
CLUSTER_MAX_CTAS = 8
CLUSTER_MAX_WARPS = 20
# Warps a CTA, from `benches/band_sweep.py --past-plan` (NVIDIA H100 80GB
# HBM3, 700 W; PERF.md).  A batch whose clusters fill the card takes CTAs
# of CLUSTER_WARPS warps: one strip a warp, 128 pairs of 10,000 bytes, 20
# warps a pair: 2 x 10 48.2 ms, 2 x 11 54.1, 5 x 4 56.1, 4 x 5 65.8, 3 x 7
# 71.5 (two CTAs of 10 warps an SM put the batch on the card in one wave;
# again 47.0 against 53.4 - 78.5 with the ring); a ring (fewer warps than
# strips) whole CTAs of them, as many as come nearest what meets a row:
# 64 pairs of 90,000 bytes at band 10,017 (21 strips meet a row), 2 x 10
# 213.6 ms, 5 x 4 238.1, 2 x 16 246.6, 7 x 3 263.6, 4 x 4 292.0, 7 x 4
# 308.1, 6 x 4 310.2, 3 x 7 326.7, 4 x 5 333.8, 4 x 7 410.1 (64 x 2 CTAs:
# one an SM).  A smaller batch spreads each pair over CTAs of
# CLUSTER_SPREAD_WARPS, one warp a scheduler (1 pair at band 20,001: 5 x
# 4 17.7 ms, 7 x 3 17.9, 4 x 5 22.0, 2 x 10 27.2; 16 pairs: 5 x 4 18.3, 8
# x 3 22.2; 2 pairs of 90,000 bytes at band 10,017: 24 warps 6 x 4 142.1,
# 8 x 3 142.1, 7 x 4 141.9, 5 x 4 144.1, and with 5 or more warps a CTA
# 169.1 - 173.7, 2 x 10 209.6, 1 x 20 316.2, 16 warps 176.6).
CLUSTER_WARPS = 10
CLUSTER_SPREAD_WARPS = 4


def _round_up(x: int, mult: int) -> int:
    return -(-x // mult) * mult


# The widest untraced band, and the widest band of the block regime: the
# bands the earlier body took that kept a pair's band state in a block's
# shared memory (6 rows of W ints, one int a warp and a code byte a cell,
# within 232,448 bytes: unit_k 4,096 at a power of two, W 9,291 at most),
# so that no batch changed regime when the block regime took its place.
MAX_UNIT_K = 4096
MAX_WIDE_BAND = 9291


def _full_band(max_m: int, unit_k: int) -> bool:
    """Whether the cluster regime's strips must cover every band column:
    it codes the band's cells right of column n + 2 as 1, which holds
    while every chain value there stays under INF: there e <= mc (m + 1)
    + 2 sgc + gc unit_k (a diagonal path to (i - 1, n - 1), then one gap),
    bounded here with every cost at 255.  Past that the strips reach
    column m + unit_k and compute those cells."""
    return 255 * (max_m + unit_k + 3) >= INF


def _cluster_strips(max_m: int, max_n: int, unit_k: int) -> int:
    """Strips of 512 columns of the batch's longest pair: columns 0 .. n +
    2, or with `_full_band` every band column."""
    cols = max_n + 3
    if _full_band(max_m, unit_k):
        cols = max(cols, max_m + unit_k + 1)
    return -(-cols // CLUSTER_COLS_PER_WARP)


def _cluster_map(max_m: int, max_n: int, unit_k: int,
                 batch: Optional[int]) -> Tuple[int, int]:
    """(CTAs a cluster, warps a CTA): as many warps as strips meet one row
    (a band of W cells meets at most ceil(W / 512) + 1 of them), so that
    no warp's next strip waits for its last, and no more than the pair's
    strips (so that a band as wide as the matrix keeps one strip a warp);
    capped at 8 CTAs of 20 warps.  CTAs of CLUSTER_WARPS warps (a ring:
    whole ones, the count nearest that), or, for a batch whose clusters
    would leave SMs empty, of CLUSTER_SPREAD_WARPS."""
    W = 2 * unit_k + 1
    strips = _cluster_strips(max_m, max_n, unit_k)
    warps = min(strips, -(-W // CLUSTER_COLS_PER_WARP) + 1,
                CLUSTER_MAX_CTAS * CLUSTER_MAX_WARPS)
    ctas = -(-warps // CLUSTER_WARPS)
    if batch is not None and batch * ctas < SM_COUNT:
        ctas = -(-warps // CLUSTER_SPREAD_WARPS)
    elif warps < strips:  # a ring: whole CTAs of CLUSTER_WARPS
        ctas = max(1, (warps + CLUSTER_WARPS // 2) // CLUSTER_WARPS)
        warps = ctas * CLUSTER_WARPS
    ctas = min(max(ctas, -(-warps // CLUSTER_MAX_WARPS)), CLUSTER_MAX_CTAS)
    return ctas, -(-warps // ctas)


def _block_map(W: int, batch: Optional[int]) -> Tuple[int, int]:
    """(cells a lane, warps a pair) of the block regime: 9 cells a lane
    where NINE_CELL_WARPS warps of them hold the band (a batch of fewer
    pairs than the card has SMs takes more of them: a shorter chain a row),
    else 17; the fewest warps that hold the band."""
    few = batch is not None and batch < SM_COUNT
    cells = 9 if -(-W // (32 * 9)) <= NINE_CELL_WARPS[few] else 17
    return cells, -(-W // (32 * cells))


def _warp_map(W: int, batch: Optional[int]) -> Tuple[int, int, int]:
    """(cells a lane, lanes a pair, threads a block) of the warp regime."""
    maps = [(g * c, g, c) for c in WARP_CELLS for g in WARP_LANES
            if g * c >= W]
    _, lanes, cells = min(maps)
    if batch is not None and batch * lanes < SMALL_BATCH_WARPS * 32:
        lanes = max(WARP_LANES)
        cells = min(c for c in WARP_CELLS if lanes * c >= W)
        return cells, lanes, SMALL_THREADS
    return cells, lanes, FULL_THREADS


def band_plan(max_m: int, unit_k: int, trace: bool = False,
              batch: Optional[int] = None,
              max_n: Optional[int] = None) -> Optional[dict]:
    """How the band kernel runs a batch of `batch` pairs (None: a batch
    that fills the card) whose b strings are at most `max_n` long (None:
    max_m + unit_k, the most the band admits), or None when it cannot.

    The limit is the band, not string length: the strings stream from
    global memory, so `max_m` does not bound the plan (it sizes the traced
    kernel's code rows only).  Up to MAX_WARP_BAND cells the warp regime
    runs (`regime` "warp"): `lanes_per_pair` lanes of one warp hold a
    pair's band in registers, `cells_per_lane` consecutive cells a lane,
    `threads` threads a block.  Past it, up to MAX_WIDE_BAND cells, the
    block regime (`regime` "wide"): one pair a block of `warps_per_pair`
    warps, `cells_per_lane` cells a lane in registers (`_block_map`); every
    untraced band up to MAX_UNIT_K.  A traced batch past that, up to
    MAX_TRACE_UNIT_K, runs the cluster regime (`regime` "wide_cluster"):
    one pair a cluster of `ctas_per_pair` CTAs of `threads` threads, 16
    columns of the matrix a lane (`cells_per_lane`), the warps a ring over
    the pair's strips of 512 columns (`_cluster_map`), any b length;
    `full_band` where the strips must cover every band column
    (`_full_band`); `scratch_bytes_per_pair`: the wrap's buffer in device
    memory (16 bytes a row and two more), which the wrapper allocates.
    Untraced batches past MAX_UNIT_K have other kernels (K5, K9): None.
    """
    if unit_k < 0 or max_m < 0:
        return None
    W = 2 * unit_k + 1
    if max_n is None:
        max_n = max_m + unit_k
    scratch = 0
    if W <= MAX_WARP_BAND:
        cells, lanes, threads = _warp_map(W, batch)
        plan = {"regime": "warp", "cells_per_lane": cells,
                "lanes_per_pair": lanes, "warps_per_pair": 1,
                "threads": threads, "pairs_per_block": threads // lanes,
                "smem_bytes": 0}
    elif W <= MAX_WIDE_BAND:
        cells, warps = _block_map(W, batch)
        plan = {"regime": "wide", "cells_per_lane": cells,
                "lanes_per_pair": 32 * warps, "warps_per_pair": warps,
                "threads": 32 * warps, "pairs_per_block": 1,
                # static shared memory: a hand-over slot (3 ints) and a
                # total (1 int) a warp of the instantiation
                "smem_bytes": 16 * BLOCK_MAX_WARPS[cells]}
    elif trace and unit_k <= MAX_TRACE_UNIT_K:
        ctas, warps = _cluster_map(max_m, max_n, unit_k, batch)
        plan = {"regime": "wide_cluster", "cells_per_lane": 16,
                "lanes_per_pair": 32 * warps * ctas,
                "warps_per_pair": warps * ctas, "threads": 32 * warps,
                "ctas_per_pair": ctas, "pairs_per_block": 1,
                "smem_bytes": 0, "full_band": _full_band(max_m, unit_k)}
        scratch = _wrap_bytes(max(max_m, 1))
    else:
        return None
    plan["scratch_bytes_per_pair"] = scratch
    plan["code_words"] = code_words(W) if trace else 0
    plan["code_bytes_per_pair"] = (max(max_m, 1) * code_words(W) * 4
                                   if trace else 0)
    return plan


def _wrap_bytes(rows: int) -> int:
    """The cluster regime's wrap buffer of one pair: a 16-byte hand-over
    slot for each of rows 0 .. rows + 1."""
    return 16 * (rows + 2)


def _check_plan(plan: dict, W: int) -> None:
    """A plan handed to a wrapper (band_plan's, or one a sweep made) is one
    the kernel takes."""
    threads = plan["threads"]
    if plan["regime"] == "wide_cluster":
        # any band up to the cap (a check may force it onto a narrow one)
        ok = (1 <= plan["ctas_per_pair"] <= CLUSTER_MAX_CTAS
              and threads % 32 == 0
              and 32 <= threads <= 32 * CLUSTER_MAX_WARPS
              and W <= 2 * MAX_TRACE_UNIT_K + 1
              and isinstance(plan.get("full_band"), bool))
    elif plan["regime"] == "warp":
        ok = (plan["cells_per_lane"] in WARP_CELLS
              and plan["lanes_per_pair"] in WARP_LANES
              and plan["cells_per_lane"] * plan["lanes_per_pair"] >= W
              and threads % 32 == 0 and 32 <= threads <= WARP_MAX_THREADS)
    elif plan["regime"] == "wide":
        # any band its warps hold (a check may force it onto a narrow one)
        cells, warps = plan["cells_per_lane"], plan["warps_per_pair"]
        ok = (cells in BLOCK_CELLS and 1 <= warps <= BLOCK_MAX_WARPS[cells]
              and threads == 32 * warps and 32 * cells * warps >= W)
    else:
        ok = False
    if not ok:
        raise ValueError(f"the band kernel does not take the plan {plan} "
                         f"at band {W}")


def select_band_dtype(
    max_k: int, unit_k: int, costs_t: CostsT
) -> Tuple[str, int]:
    """Pick the narrowest band-state dtype with enough headroom.

    Mirrors the reference's Jewel-width dispatch rules
    (levenshtein.rs:766-823: smallest lane width with
    `max_k <= dtype_max - 1`), for signed state: every intermediate the
    recurrence forms must stay within the dtype —
      * per-step adds:            inf + max(mc, sgc+gc, tc)
      * affine-chain intermediate e: inf + sgc + (W-1)*gc
      * slope-adjusted g lower bound: -(W-1)*gc
    so inf = dtype_max - max(those terms); the dtype is usable when
    inf > max_k (distances above max_k may saturate at inf: DP values
    along an optimal path are monotone non-decreasing, so no cell on a
    path with final cost <= max_k ever exceeds max_k).

    Returns (dtype name, inf sentinel).  The kernels keep int32 state so
    far; this rule is what a narrower state would be chosen by.
    """
    mc, gc, sgc, tc, _ = costs_t
    W = 2 * unit_k + 1
    slack = max(mc, sgc + gc, tc, gc, sgc + (W - 1) * gc)
    for name, dmax, dmin in (("int8", 127, -128), ("int16", 32767, -32768)):
        inf = dmax - slack
        if inf > max_k and -(W - 1) * gc >= dmin:
            return name, inf
    return "int32", int(INF)


def prepare_band_tensors(a_list: Sequence[np.ndarray],
                         b_list: Sequence[np.ndarray], unit_k: int,
                         max_m: int, *, device):
    """Pack a batch (len(a) <= len(b) <= len(a) + unit_k, len(a) <= max_m
    per pair) into the kernel's tensors on `device`.

    Returns (a_t uint8 [B, max_m16], b_t uint8 [B, max_m16 + W], m, n
    int32 [B]) in pair order; max_m16 is max_m rounded up to 16 (at least
    16), so the rows exist for an all-empty batch too.
    """
    W = 2 * unit_k + 1
    B = len(a_list)
    mm = _round_up(max(max_m, 1), 16)
    la = np.fromiter((len(x) for x in a_list), np.int64, B)
    lb = np.fromiter((len(x) for x in b_list), np.int64, B)
    if not np.all((la <= lb) & (lb - la <= unit_k) & (la <= max_m)):
        raise ValueError(
            "every pair needs len(a) <= len(b) <= len(a) + unit_k and "
            "len(a) <= max_m")
    a_rows = np.zeros((B, mm), dtype=np.uint8)
    b_rows = np.zeros((B, mm + W), dtype=np.uint8)
    # contiguous per-pair row writes (a fancy-index scatter of every char
    # builds index arrays several times the size of the strings)
    for p, (a, b) in enumerate(zip(a_list, b_list)):
        a_rows[p, :len(a)] = a
        b_rows[p, unit_k:unit_k + len(b)] = b
    dev = torch.device(device)
    return (
        torch.from_numpy(a_rows).to(dev),
        torch.from_numpy(b_rows).to(dev),
        torch.from_numpy(la.astype(np.int32)).to(dev),
        torch.from_numpy(lb.astype(np.int32)).to(dev),
    )


def from_reference_batch(a_t: np.ndarray, b_t: np.ndarray, m: np.ndarray,
                         n: np.ndarray, c_fin: np.ndarray, *, unit_k: int,
                         max_m: int, device):
    """Bridge from the JAX package's band-kernel inputs to the port's.

    Takes the numpy arrays `lev_band.prepare_pallas_inputs` returns —
    row-major uint8 `a_t` [B, max_m] and `b_t` [B, max_m + W] with 0 pads,
    `m`, `n`, `c_fin` int32 [1, B] — or the transposed int32 sentinel
    layout the kernels also take (`a_t` [max_m, B], `b_t` [max_m + W, B],
    pads -1 / -2), and returns (a_t, b_t, m, n) in the port's layout on
    `device`, pair p of the reference at row p (the reference pads the
    batch to a multiple of 128 with empty pairs; the caller keeps the
    first B results: the reference gives its pad pairs `c_fin` 0 and so
    an infinite result, the port gives an empty pair 0).  `c_fin` is
    checked on the real pairs, not carried: the port's kernel derives the
    final cell from m, n and unit_k.
    """
    W = 2 * unit_k + 1
    m1 = np.asarray(m).reshape(-1).astype(np.int32)
    n1 = np.asarray(n).reshape(-1).astype(np.int32)
    B = m1.size
    cf = np.asarray(c_fin).reshape(-1)
    batch_pad = (m1 == 0) & (n1 == 0) & (cf == 0)
    if not np.all((cf == np.clip(n1 - m1 + unit_k, 0, W - 1)) | batch_pad):
        raise ValueError("c_fin is not clip(n - m + unit_k, 0, W - 1)")
    a_src, b_src = np.asarray(a_t), np.asarray(b_t)
    if a_src.dtype != np.uint8:  # transposed sentinel layout
        a_src = np.where(a_src < 0, 0, a_src).T.astype(np.uint8)
        b_src = np.where(b_src < 0, 0, b_src).T.astype(np.uint8)
    if a_src.shape != (B, max_m) or b_src.shape != (B, max_m + W):
        raise ValueError("reference arrays do not have the stated shapes")
    mm = _round_up(max(max_m, 1), 16)
    a_rows = np.zeros((B, mm), dtype=np.uint8)
    b_rows = np.zeros((B, mm + W), dtype=np.uint8)
    a_rows[:, :max_m] = a_src
    b_rows[:, :max_m + W] = b_src
    dev = torch.device(device)
    return tuple(torch.from_numpy(x).to(dev)
                 for x in (a_rows, b_rows, m1, n1))


def _check_inputs(a_t, b_t, m, n, unit_k: int, costs_t: CostsT,
                  trace: bool) -> int:
    if band_plan(0, unit_k, trace) is None:
        cap = MAX_TRACE_UNIT_K if trace else MAX_UNIT_K
        raise ValueError(
            f"unit_k={unit_k} exceeds the band plan (unit_k <= {cap})")
    W = 2 * unit_k + 1
    if a_t.dtype != torch.uint8 or b_t.dtype != torch.uint8:
        raise TypeError("a_t and b_t must be uint8")
    if a_t.dim() != 2 or b_t.dim() != 2 or b_t.shape[0] != a_t.shape[0]:
        raise ValueError("a_t and b_t must be [B, len] with the same B")
    if a_t.shape[1] < 1 or b_t.shape[1] != a_t.shape[1] + W:
        raise ValueError(f"row lengths must be max_m >= 1 and max_m + {W}")
    B = a_t.shape[0]
    for t in (m, n):
        if t.dtype != torch.int32 or t.shape != (B,):
            raise ValueError("m and n must be int32 [B]")
    devs = {t.device for t in (a_t, b_t, m, n)}
    if len(devs) != 1:
        raise ValueError(f"inputs lie on different devices: {devs}")
    mc, gc, sgc, tc, _ = costs_t
    if not (0 < mc <= 255 and 0 < gc <= 255 and 0 <= sgc <= 255
            and 0 <= tc <= 255):
        raise ValueError(f"costs {costs_t} outside the u8 range")
    return W


def _plan_for(a_t, n, unit_k: int, trace: bool, plan: Optional[dict],
              max_n: Optional[int]) -> dict:
    """The plan of this batch (`band_plan`'s, or the one handed in, checked);
    the cluster regime's map is chosen from the batch's longest b (`max_n`,
    read from `n` when not given), and a cluster plan handed in must cover
    the band where the batch needs it (`_full_band`)."""
    B, rows = a_t.shape
    W = 2 * unit_k + 1
    if plan is None:
        if max_n is None and trace and W > MAX_WIDE_BAND:
            max_n = int(n.max()) if B else 0  # only past the block regime
        return band_plan(rows, unit_k, trace, batch=B, max_n=max_n)
    _check_plan(plan, W)
    if plan["regime"] == "wide_cluster" and not (
            trace and (plan["full_band"] or not _full_band(rows, unit_k))):
        raise ValueError(f"the band kernel's cluster plan {plan} does not "
                         f"take this batch (traced {trace}, {rows} rows at "
                         f"unit_k {unit_k})")
    return plan


def _launch(a_t, b_t, m, n, unit_k: int, costs_t: CostsT, trace: bool,
            plan: dict):
    """Launch the CUDA band kernel; (dist, codes or None)."""
    from ..utils.build import check_launch, load_kernels

    lib = load_kernels()
    W = 2 * unit_k + 1
    tensors = [t.contiguous() for t in (a_t, b_t, m, n)]
    B, rows = a_t.shape
    out = torch.empty(B, dtype=torch.int32, device=a_t.device)
    codes = None
    if trace:
        codes = torch.empty((B, rows, code_words(W)), dtype=torch.int32,
                            device=a_t.device)
    mc, gc, sgc, tc, allow_transpose = costs_t
    with torch.cuda.device(a_t.device):
        stream = torch.cuda.current_stream().cuda_stream
        head = (*(t.data_ptr() for t in tensors), out.data_ptr(),
                codes.data_ptr() if trace and B else None, B,
                tensors[0].shape[1], tensors[1].shape[1], unit_k, rows, mc,
                gc, sgc, tc, int(bool(allow_transpose)))
        if plan["regime"] == "wide_cluster":
            # the wrap's buffer: any contents (each slot is written before
            # it is read)
            wrap = torch.empty(max(B, 1) * _wrap_bytes(rows) // 4,
                               dtype=torch.int32, device=a_t.device)
            code = lib.ta_band_trace_cluster(
                *head, plan["ctas_per_pair"], plan["threads"] // 32,
                int(plan["full_band"]), wrap.data_ptr(), stream)
        elif plan["regime"] == "wide":
            code = lib.ta_band_block(*head, plan["cells_per_lane"],
                                     plan["warps_per_pair"], stream)
        else:
            code = lib.ta_band_distance(*head, plan["threads"],
                                        plan["cells_per_lane"],
                                        plan["lanes_per_pair"], stream)
    check_launch(lib, code, "band_trace" if trace else "band_distance")
    return out, codes


def band_distance(a_t: torch.Tensor, b_t: torch.Tensor, m: torch.Tensor,
                  n: torch.Tensor, *, unit_k: int, costs_t: CostsT,
                  plan: Optional[dict] = None) -> torch.Tensor:
    """Banded general-cost distances, int32 [B] in pair order; >= INF where
    the pair's final cell lies outside what the band reaches.

    CUDA tensors launch the hand-written kernel (built at first use) and
    count one launch in `band_distance.launches`; a build or launch
    failure raises.  Every m must be <= max_m (the kernel walks m rows of
    its pair and does not look at max_m).  `plan`: `band_plan`'s for this
    batch when None; a sweep or a check may hand another one the kernel
    takes.  CPU tensors — and only those — take the plain PyTorch version.
    """
    _check_inputs(a_t, b_t, m, n, unit_k, costs_t, False)
    plan = _plan_for(a_t, n, unit_k, False, plan, None)
    if a_t.device.type == "cpu":
        return band_scan_distance(a_t, b_t, m, n, unit_k=unit_k,
                                  costs_t=costs_t, trace_on=False)[0]
    if a_t.device.type != "cuda":
        raise ValueError(f"unsupported device {a_t.device}")
    out, _ = _launch(a_t, b_t, m, n, unit_k, costs_t, False, plan)
    if a_t.shape[0]:
        band_distance.launches += 1
    return out


band_distance.launches = 0


def band_trace(a_t: torch.Tensor, b_t: torch.Tensor, m: torch.Tensor,
               n: torch.Tensor, *, unit_k: int, costs_t: CostsT,
               plan: Optional[dict] = None, max_n: Optional[int] = None):
    """Banded distances and packed argmin codes: (dist int32 [B], codes
    int32 [B, max_m, ceil(W / 16)]).  Only code rows 0..m-1 of a pair are
    defined.  The codes stay on the device for the walk
    (`trace_walk.trace_walk`).  Past MAX_UNIT_K the plan is the cluster
    regime, up to MAX_TRACE_UNIT_K; `max_n`, the longest b of the batch,
    which picks its map, is read from `n` (one copy to the host) when not
    given.

    CUDA tensors launch the hand-written kernel and count one launch in
    `band_trace.launches`; `plan` as in `band_distance`.  CPU tensors — and
    only those — take the plain PyTorch version.
    """
    _check_inputs(a_t, b_t, m, n, unit_k, costs_t, True)
    plan = _plan_for(a_t, n, unit_k, True, plan, max_n)
    if a_t.device.type == "cpu":
        return band_scan_distance(a_t, b_t, m, n, unit_k=unit_k,
                                  costs_t=costs_t, trace_on=True)
    if a_t.device.type != "cuda":
        raise ValueError(f"unsupported device {a_t.device}")
    out, codes = _launch(a_t, b_t, m, n, unit_k, costs_t, True, plan)
    if a_t.shape[0]:
        band_trace.launches += 1
    return out, codes


band_trace.launches = 0
