"""ctypes loader for the native (C++) host components.

Own copy, for the PyTorch/CUDA port, of the JAX package's loader.  The
device layer is PyTorch + hand-written CUDA; the host-side sequential
passes (match post-processing, the All-mode length replay of search hits,
the compiled CPU comparators) have a native C++ implementation under
native/, built with `make -C native`.  Python fallbacks exist for every
native entry point used by the port, so the library works without the
shared object; `native_available()` reports which path is live.
``TRIPLE_ACCEL_TORCH_NO_NATIVE=1`` switches the library off.
"""

from __future__ import annotations

import ctypes
import os
from functools import lru_cache
from typing import List, Optional

import numpy as np

from ..types import Match

__all__ = [
    "native_available",
    "postprocess_matches_native",
    "myers_distance_batch_native",
    "scalar_banded_batch_native",
    "search_all_native",
    "search_intervals_native",
]

_LIB_NAME = "libta_native.so"


def _load() -> Optional[ctypes.CDLL]:
    # the switch is read on every call so a process can turn the library
    # off and on again; only the dlopen is cached
    if os.environ.get("TRIPLE_ACCEL_TORCH_NO_NATIVE", "") not in ("", "0"):
        return None
    return _load_lib()


@lru_cache(maxsize=1)
def _load_lib() -> Optional[ctypes.CDLL]:
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    candidates = [
        os.path.join(here, "native", _LIB_NAME),
        os.path.join(os.path.dirname(os.path.abspath(__file__)), _LIB_NAME),
    ]
    for path in candidates:
        if os.path.exists(path):
            try:
                lib = ctypes.CDLL(path)
            except OSError:
                continue
            i64p = ctypes.POINTER(ctypes.c_int64)
            lib.ta_postprocess_matches.restype = ctypes.c_int64
            lib.ta_postprocess_matches.argtypes = [
                i64p, i64p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
                ctypes.c_int64, i64p, i64p, i64p,
            ]
            u8p = ctypes.POINTER(ctypes.c_uint8)
            if hasattr(lib, "ta_myers_distance_batch"):
                lib.ta_myers_distance_batch.restype = ctypes.c_int64
                lib.ta_myers_distance_batch.argtypes = [
                    u8p, i64p, ctypes.c_int64, u8p, i64p, ctypes.c_int64,
                    ctypes.c_int64, ctypes.c_int64, i64p,
                ]
            if hasattr(lib, "ta_scalar_banded_batch"):
                lib.ta_scalar_banded_batch.restype = ctypes.c_int64
                lib.ta_scalar_banded_batch.argtypes = [
                    u8p, i64p, ctypes.c_int64, u8p, i64p, ctypes.c_int64,
                    ctypes.c_int64, ctypes.c_int64,
                    ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                    ctypes.c_int32, ctypes.c_int32, i64p,
                ]
            if hasattr(lib, "ta_search_all"):
                lib.ta_search_all.restype = ctypes.c_int64
                lib.ta_search_all.argtypes = [
                    u8p, ctypes.c_int64, u8p, ctypes.c_int64,
                    ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
                    ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                    ctypes.c_int32, ctypes.c_int64, i64p, i64p, i64p,
                ]
            if hasattr(lib, "ta_search_intervals"):
                lib.ta_search_intervals.restype = ctypes.c_int64
                lib.ta_search_intervals.argtypes = [
                    u8p, ctypes.c_int64, u8p, ctypes.c_int64,
                    i64p, i64p, ctypes.c_int64, ctypes.c_int64,
                    ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                    ctypes.c_int32, ctypes.c_int32, ctypes.c_int64,
                    i64p, i64p, i64p,
                ]
            return lib
    return None


def native_available() -> bool:
    return _load() is not None


def _as_i64_ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def postprocess_matches_native(
    dists: np.ndarray, lengths: np.ndarray, k: int, best: bool
) -> Optional[List[Match]]:
    """Native streaming Best/All pass; None if the library isn't built."""
    lib = _load()
    if lib is None:
        return None
    dists = np.ascontiguousarray(dists, dtype=np.int64)
    lengths = np.ascontiguousarray(lengths, dtype=np.int64)
    n = len(dists)
    cap = n if n else 1
    out_s = np.empty(cap, dtype=np.int64)
    out_e = np.empty(cap, dtype=np.int64)
    out_k = np.empty(cap, dtype=np.int64)
    cnt = lib.ta_postprocess_matches(
        _as_i64_ptr(dists), _as_i64_ptr(lengths), n, k, 1 if best else 0,
        cap, _as_i64_ptr(out_s), _as_i64_ptr(out_e), _as_i64_ptr(out_k),
    )
    return [
        Match(start=int(out_s[i]), end=int(out_e[i]), k=int(out_k[i]))
        for i in range(cnt)
    ]


def _pack_batch(seqs) -> "tuple[np.ndarray, np.ndarray, int]":
    from ..types import to_bytes_array

    arrs = [to_bytes_array(s) for s in seqs]
    lens = np.array([len(s) for s in arrs], dtype=np.int64)
    stride = int(lens.max(initial=1))
    buf = np.zeros((len(arrs), stride), dtype=np.uint8)
    for i, s in enumerate(arrs):
        buf[i, : len(s)] = s
    return buf, lens, stride


def myers_distance_batch_native(a_list, b_list, k: int) -> Optional[np.ndarray]:
    """Compiled bit-parallel Myers (64-bit words) unit-cost distance batch —
    the strongest simple single-core CPU algorithm for this workload, used
    as the "best CPU" comparator and as the kernel-independent reference
    of chip_smoke.py.  Returns int64 distances (-1 over
    threshold), or None if the library isn't built."""
    lib = _load()
    if lib is None or not hasattr(lib, "ta_myers_distance_batch"):
        return None
    a_buf, a_lens, a_stride = _pack_batch(a_list)
    b_buf, b_lens, b_stride = _pack_batch(b_list)
    out = np.empty(len(a_list), dtype=np.int64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.ta_myers_distance_batch(
        a_buf.ctypes.data_as(u8p), _as_i64_ptr(a_lens), a_stride,
        b_buf.ctypes.data_as(u8p), _as_i64_ptr(b_lens), b_stride,
        len(a_list), k, _as_i64_ptr(out),
    )
    return out


def scalar_banded_batch_native(a_list, b_list, k: int,
                               costs) -> Optional[np.ndarray]:
    """Compiled scalar banded distance batch (native/scalar_baseline.cpp),
    a C++ port of the oracle's banded DP for any cost model: the
    kernel-independent reference of chip_smoke.py where the Python oracle
    is too slow.  Returns int64 distances (-1 over threshold), or None if
    the library isn't built."""
    lib = _load()
    if lib is None or not hasattr(lib, "ta_scalar_banded_batch"):
        return None
    a_buf, a_lens, a_stride = _pack_batch(a_list)
    b_buf, b_lens, b_stride = _pack_batch(b_list)
    out = np.empty(len(a_list), dtype=np.int64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.ta_scalar_banded_batch(
        a_buf.ctypes.data_as(u8p), _as_i64_ptr(a_lens), a_stride,
        b_buf.ctypes.data_as(u8p), _as_i64_ptr(b_lens), b_stride,
        len(a_list), k,
        costs.mismatch_cost, costs.gap_cost, costs.start_gap_cost,
        costs.transpose_cost_or_zero, 1 if costs.allow_transpose else 0,
        _as_i64_ptr(out),
    )
    return out


def search_all_native(
    needle, haystack, k: int, costs, anchored: bool = False
) -> "Optional[tuple]":
    """All-mode search candidates via the C++ oracle port
    (native/scalar_baseline.cpp ta_search_all): every end position with
    dist <= k as (ends, dists, lengths) int64 arrays, with the exact
    maximize-length tie-break.  ~100x the Python oracle — used by the
    per-hit window replays in levenshtein._resolve_hits_batch, where a single
    long-needle window otherwise costs seconds of host time.  Returns
    None if the library isn't built (callers fall back to the oracle)."""
    lib = _load()
    if lib is None or not hasattr(lib, "ta_search_all"):
        return None
    from ..types import to_bytes_array

    nd = np.ascontiguousarray(to_bytes_array(needle))
    hy = np.ascontiguousarray(to_bytes_array(haystack))
    u8p = ctypes.POINTER(ctypes.c_uint8)
    cap = len(hy) + 2
    while True:
        out_e = np.empty(cap, dtype=np.int64)
        out_k = np.empty(cap, dtype=np.int64)
        out_l = np.empty(cap, dtype=np.int64)
        cnt = lib.ta_search_all(
            nd.ctypes.data_as(u8p), len(nd), hy.ctypes.data_as(u8p),
            len(hy), k,
            costs.mismatch_cost, costs.gap_cost, costs.start_gap_cost,
            costs.transpose_cost_or_zero,
            1 if costs.allow_transpose else 0, 1 if anchored else 0,
            cap, _as_i64_ptr(out_e), _as_i64_ptr(out_k), _as_i64_ptr(out_l),
        )
        if cnt >= 0:
            return out_e[:cnt], out_k[:cnt], out_l[:cnt]
        cap *= 2


def search_intervals_native(
    needle, haystack, starts: np.ndarray, ends: np.ndarray, k: int, costs
) -> "Optional[tuple]":
    """All-mode search candidates over disjoint haystack intervals in ONE
    C++ call (native/scalar_baseline.cpp ta_search_intervals): every
    (global end, dist, length) with dist <= k whose end lies in one of the
    intervals [starts[i], ends[i]).  Replaces the per-hit Python replay
    loop — for dense hit streams the merged intervals collapse into a
    single O(n*m) streaming pass.  Returns None if the library isn't
    built (callers fall back to the per-interval Python oracle)."""
    lib = _load()
    if lib is None or not hasattr(lib, "ta_search_intervals"):
        return None
    from ..types import to_bytes_array

    nd = np.ascontiguousarray(to_bytes_array(needle))
    hy = np.ascontiguousarray(to_bytes_array(haystack))
    st = np.ascontiguousarray(starts, dtype=np.int64)
    en = np.ascontiguousarray(ends, dtype=np.int64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    cap = int(np.maximum(en - st, 0).sum()) + 2 * max(len(st), 1)
    while True:
        out_e = np.empty(cap, dtype=np.int64)
        out_k = np.empty(cap, dtype=np.int64)
        out_l = np.empty(cap, dtype=np.int64)
        cnt = lib.ta_search_intervals(
            nd.ctypes.data_as(u8p), len(nd), hy.ctypes.data_as(u8p),
            len(hy), _as_i64_ptr(st), _as_i64_ptr(en), len(st), k,
            costs.mismatch_cost, costs.gap_cost, costs.start_gap_cost,
            costs.transpose_cost_or_zero,
            1 if costs.allow_transpose else 0,
            cap, _as_i64_ptr(out_e), _as_i64_ptr(out_k), _as_i64_ptr(out_l),
        )
        if cnt >= 0:
            return out_e[:cnt], out_k[:cnt], out_l[:cnt]
        cap *= 2
