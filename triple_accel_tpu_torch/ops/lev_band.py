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
`band_scan.walk_packed_traceback` walks back on the device.

One kernel serves the two regimes the TPU split into an untiled and a
row-strip tiled kernel: the strings stream from global memory, so length is
unbounded, and the band lives in the block's shared memory, which bounds W.

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
MAX_THREADS = 1024
# Band cells a thread walks serially when the block is not yet full.  One
# value for every band and batch, a middle point of
# `benches/band_sweep.py` (H100 80GB HBM3, 700 W): at band 65 one warp a
# pair (4 or more) is best, 72.7 ms against 108.1 at 2; a full card of long
# pairs wants more cells a thread (band 513: 198.4 ms at 4, 108.3 at 16);
# a batch too small to fill the card wants fewer (256 pairs, band 129:
# 3.02 ms at 4, 2.49 at 2).  A rule that looks at the batch is not written
# yet.
CELLS_PER_THREAD = 4


def _round_up(x: int, mult: int) -> int:
    return -(-x // mult) * mult


def _smem_bytes(W: int) -> int:
    """Shared memory of one pair's block: 6 rows of W ints (three of D, two
    of the vertical-gap state, one transposition scratch), one word per
    warp for the scan, one code byte a cell."""
    return (6 * W + 32) * 4 + ((W + 3) & ~3)


def _max_unit_k() -> int:
    uk = 1
    while _smem_bytes(2 * (2 * uk) + 1) <= SMEM_BYTES_PER_BLOCK:
        uk *= 2
    return uk


MAX_UNIT_K = _max_unit_k()  # 4096: W = 8193, 6 * W ints = 192 KB


def band_plan(max_m: int, unit_k: int, trace: bool = False) -> Optional[dict]:
    """How the band kernel runs a batch, or None when it cannot.

    The limit is Hopper's shared memory, not string length: the band state
    of one pair (6 * W ints) must fit the 227 KB a block may use, so
    unit_k <= 4096; the strings stream from global memory, so `max_m` does
    not bound the plan (it sizes the traced kernel's code rows only).
    Threads: one for every CELLS_PER_THREAD band cells, rounded up to whole
    warps, at most 1024; a thread then walks ceil(W / threads) cells of
    each row in registers and the rest of the row exchange goes through
    shared memory and one warp scan.
    """
    if unit_k < 0 or max_m < 0:
        return None
    W = 2 * unit_k + 1
    smem = _smem_bytes(W)
    if smem > SMEM_BYTES_PER_BLOCK:
        return None
    threads = min(MAX_THREADS,
                  _round_up(-(-W // CELLS_PER_THREAD), 32))
    return {
        "threads": threads,
        "cells_per_thread": -(-W // threads),
        "smem_bytes": smem,
        "code_words": code_words(W) if trace else 0,
        "code_bytes_per_pair": max(max_m, 1) * code_words(W) * 4
        if trace else 0,
    }


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


def _check_inputs(a_t, b_t, m, n, unit_k: int, costs_t: CostsT) -> int:
    if band_plan(a_t.shape[1] if a_t.dim() == 2 else 0, unit_k) is None:
        raise ValueError(
            f"unit_k={unit_k} exceeds the band plan (unit_k <= {MAX_UNIT_K})")
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


def _launch(a_t, b_t, m, n, unit_k: int, costs_t: CostsT, trace: bool):
    """Launch the CUDA band kernel; (dist, codes or None)."""
    from ..utils.build import check_launch, load_kernels

    lib = load_kernels()
    W = 2 * unit_k + 1
    tensors = [t.contiguous() for t in (a_t, b_t, m, n)]
    B, rows = a_t.shape
    plan = band_plan(rows, unit_k, trace)
    out = torch.empty(B, dtype=torch.int32, device=a_t.device)
    codes = None
    if trace:
        codes = torch.empty((B, rows, plan["code_words"]), dtype=torch.int32,
                            device=a_t.device)
    mc, gc, sgc, tc, allow_transpose = costs_t
    with torch.cuda.device(a_t.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.ta_band_distance(
            *(t.data_ptr() for t in tensors), out.data_ptr(),
            codes.data_ptr() if trace and B else None, B,
            tensors[0].shape[1], tensors[1].shape[1], unit_k, rows,
            mc, gc, sgc, tc, int(bool(allow_transpose)),
            plan["threads"], stream,
        )
    check_launch(lib, code, "band_trace" if trace else "band_distance")
    return out, codes


def band_distance(a_t: torch.Tensor, b_t: torch.Tensor, m: torch.Tensor,
                  n: torch.Tensor, *, unit_k: int,
                  costs_t: CostsT) -> torch.Tensor:
    """Banded general-cost distances, int32 [B] in pair order; >= INF where
    the pair's final cell lies outside what the band reaches.

    CUDA tensors launch the hand-written kernel (built at first use) and
    count one launch in `band_distance.launches`; a build or launch
    failure raises.  Every m must be <= max_m (the kernel walks m rows of
    its pair and does not look at max_m).  CPU tensors — and only those —
    take the plain PyTorch version.
    """
    _check_inputs(a_t, b_t, m, n, unit_k, costs_t)
    if a_t.device.type == "cpu":
        return band_scan_distance(a_t, b_t, m, n, unit_k=unit_k,
                                  costs_t=costs_t, trace_on=False)[0]
    if a_t.device.type != "cuda":
        raise ValueError(f"unsupported device {a_t.device}")
    out, _ = _launch(a_t, b_t, m, n, unit_k, costs_t, False)
    if a_t.shape[0]:
        band_distance.launches += 1
    return out


band_distance.launches = 0


def band_trace(a_t: torch.Tensor, b_t: torch.Tensor, m: torch.Tensor,
               n: torch.Tensor, *, unit_k: int, costs_t: CostsT):
    """Banded distances and packed argmin codes: (dist int32 [B], codes
    int32 [B, max_m, ceil(W / 16)]).  Only code rows 0..m-1 of a pair are
    defined.  The codes stay on the device for
    `band_scan.walk_packed_traceback`.

    CUDA tensors launch the hand-written kernel and count one launch in
    `band_trace.launches`; CPU tensors — and only those — take the plain
    PyTorch version.
    """
    _check_inputs(a_t, b_t, m, n, unit_k, costs_t)
    if a_t.device.type == "cpu":
        return band_scan_distance(a_t, b_t, m, n, unit_k=unit_k,
                                  costs_t=costs_t, trace_on=True)
    if a_t.device.type != "cuda":
        raise ValueError(f"unsupported device {a_t.device}")
    out, codes = _launch(a_t, b_t, m, n, unit_k, costs_t, True)
    if a_t.shape[0]:
        band_trace.launches += 1
    return out, codes


band_trace.launches = 0
