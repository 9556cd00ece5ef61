"""Public Levenshtein / restricted Damerau-Levenshtein API of the port.

Counterpart of the JAX package's `levenshtein.py`, same names and result
semantics: distances, None-above-threshold, Match{start, end, k} lists with
the reference's Best/All/overlap rules.  The port carries these device
engines and every host step around them:

* `myers` — `levenshtein_k_batch` and every wrapper that routes through it,
  unit costs, per-batch threshold up to 191 (ops/myers_distance.py);
* `band` / `band_trace` — the same entry points with any cost model, with
  unit costs past 191, and with `trace_on=True`: the general-cost band
  kernels (ops/lev_band.py, band up to unit_k 4096, any string length),
  the batched traceback walk and its RLE decode (ops/band_scan.py);
* `myers_search` / `myers_search_rdamerau` — `levenshtein_search_simd_with_opts`
  and its wrappers, unit and restricted-Damerau costs, anchored or not,
  needles up to 1280 chars (ops/myers_search.py), followed by the hit fetch
  and the All-mode length replay on the host.

Every other route of the JAX package (meshes, bands wider than the band
plan, general-cost search, longer needles, the dense-hit device resolution,
dictionary search, sharded search) raises `NotImplementedError` naming the
JAX engine that is still to be ported.  Nothing falls back to the oracle, the plain
PyTorch versions or the CPU: the same dispatch runs on both devices.

Device rule: every entry point takes a keyword-only `device=`; None means
"cuda", and a CUDA device without a card raises (`dispatch.resolve_device`).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .dispatch import (
    DispatchDecision,
    forced_path,
    resolve_device,
    round_up_pow2,
    select_cost_bucket,
)
from .oracle.levenshtein import (
    default_search_k,
    levenshtein_naive,
    levenshtein_naive_k,
    levenshtein_naive_k_with_opts,
    levenshtein_naive_with_opts,
    levenshtein_search_naive,
    levenshtein_search_naive_with_opts,
)
from .types import (
    BytesLike,
    Edit,
    EditCosts,
    LEVENSHTEIN_COSTS,
    Match,
    RDAMERAU_COSTS,
    SearchType,
    to_bytes_array,
)

__all__ = [
    "levenshtein_naive",
    "levenshtein_naive_with_opts",
    "levenshtein_naive_k",
    "levenshtein_naive_k_with_opts",
    "levenstein_naive_str",
    "levenshtein_simd_k_str",
    "levenshtein_simd_k",
    "levenshtein_simd_k_with_opts",
    "levenshtein",
    "rdamerau",
    "levenshtein_exp",
    "levenshtein_exp_with_opts",
    "rdamerau_exp",
    "levenshtein_k_batch",
    "levenshtein_exp_batch",
    "levenshtein_search_naive",
    "levenshtein_search_naive_with_opts",
    "levenshtein_search_simd",
    "levenshtein_search_sharded",
    "levenshtein_search_many",
    "PackedHaystack",
    "levenshtein_search_simd_with_opts",
    "levenshtein_search",
    "postprocess_matches",
    "translate_str",
    "LEVENSHTEIN_COSTS",
    "RDAMERAU_COSTS",
    "default_search_k",
]

U32_MAX = (1 << 32) - 1

# smallest pair group worth its own kernel launch in per-bucket dispatch
_MIN_BUCKET = 256

# bytes of packed argmin codes one traced launch may hold on the device:
# larger traced batches chunk on the batch axis (pairs walk independently).
# The walk indexes the codes with int64, so no batch overflows an index.
_TRACE_CODE_BYTES_CAP = 1 << 30

_UNIT = (1, 1, 0, 0, False)
_RDAMERAU = (1, 1, 0, 1, True)


def _not_ported(what: str, engine: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to triple_accel_tpu_torch yet: the JAX "
        f"package runs it on {engine}"
    )


# ---------------------------------------------------------------------------
# Unicode helpers (reference levenshtein.rs:609-651, 123-127)
# ---------------------------------------------------------------------------

def translate_str(chars: List[str], s: str) -> Optional[np.ndarray]:
    """Map a unicode string onto a <=256-symbol u8 alphabet shared through
    `chars` (reference levenshtein.rs:609-624).  Returns None if the
    combined alphabet exceeds 256 symbols."""
    out = np.empty(len(s), dtype=np.uint8)
    lookup = {c: i for i, c in enumerate(chars)}
    for i, c in enumerate(s):
        idx = lookup.get(c)
        if idx is None:
            idx = len(chars)
            if idx >= 256:
                return None
            chars.append(c)
            lookup[c] = idx
        out[i] = idx
    return out


def levenstein_naive_str(a: str, b: str) -> int:
    """Unicode scalar distance (sic — typo preserved from the reference,
    levenshtein.rs:123-127); any alphabet size, host only.

    >>> levenstein_naive_str("abc", "ab")
    1
    """
    return levenshtein_naive(a, b)


def levenshtein_simd_k_str(a: str, b: str, k: int, *,
                           device=None) -> Optional[int]:
    """Unicode banded distance (reference levenshtein.rs:641-651)."""
    if a.isascii() and b.isascii():
        return levenshtein_simd_k(a.encode(), b.encode(), k, device=device)
    chars: List[str] = []
    a_t = translate_str(chars, a)
    if a_t is None:
        return None
    b_t = translate_str(chars, b)
    if b_t is None:
        return None
    return levenshtein_simd_k(a_t, b_t, k, device=device)


# ---------------------------------------------------------------------------
# Distance dispatcher
# ---------------------------------------------------------------------------

def _costs_tuple(costs: EditCosts) -> Tuple[int, int, int, int, bool]:
    return (
        costs.mismatch_cost,
        costs.gap_cost,
        costs.start_gap_cost,
        costs.transpose_cost_or_zero,
        costs.allow_transpose,
    )


def levenshtein_simd_k_with_opts(
    a: BytesLike,
    b: BytesLike,
    k: int,
    trace_on: bool = False,
    costs: EditCosts = LEVENSHTEIN_COSTS,
    *,
    device=None,
) -> Optional[Tuple[int, Optional[List[Edit]]]]:
    """Banded distance with options, device accelerated
    (reference levenshtein.rs:714-827).

    Returns None when the distance exceeds the (capped) threshold; with
    `trace_on`, additionally returns the RLE edit traceback.  The
    single-pair wrapper routes through the batched dispatcher at batch
    size 1, traced or not, so it reaches the same kernels by the same
    rules (the JAX package keeps a separate single-pair scan for traces
    only to spare compiles; `band_scan.decode_traceback` is its host walk,
    kept as the scalar check of the batched walk).
    """
    dev = resolve_device(device)
    a = to_bytes_array(a)
    b = to_bytes_array(b)
    if len(a) == 0 and len(b) == 0:
        return (0, [] if trace_on else None)

    if forced_path() == "oracle":
        return levenshtein_naive_k_with_opts(a, b, k, trace_on, costs)

    if trace_on:
        dists, traces = levenshtein_k_batch([a], [b], k, costs, True,
                                            device=dev)
        return None if dists[0] < 0 else (int(dists[0]), traces[0])
    dists = levenshtein_k_batch([a], [b], k, costs, device=dev)
    if dists[0] < 0:
        return None
    return (int(dists[0]), None)


def levenshtein_simd_k(a: BytesLike, b: BytesLike, k: int, *,
                       device=None) -> Optional[int]:
    """Banded distance (reference levenshtein.rs:677-684)."""
    res = levenshtein_simd_k_with_opts(a, b, k, False, LEVENSHTEIN_COSTS,
                                       device=device)
    return None if res is None else res[0]


def levenshtein(a: BytesLike, b: BytesLike, *, device=None) -> int:
    """Exact Levenshtein distance (reference levenshtein.rs:1397-1399).
    The threshold is unbounded, so the band is about the string length:
    pairs whose capped threshold passes 191 take the general band kernel,
    and strings past its plan (band half-width over 4096) raise."""
    res = levenshtein_simd_k(a, b, U32_MAX, device=device)
    if res is None:
        raise AssertionError("an unbounded threshold always resolves")
    return res


def rdamerau(a: BytesLike, b: BytesLike, *, device=None) -> int:
    """Exact restricted Damerau-Levenshtein distance (reference
    levenshtein.rs:1419-1423), on the general band kernel; strings past
    its plan (band half-width over 4096) raise."""
    res = levenshtein_simd_k_with_opts(a, b, U32_MAX, False, RDAMERAU_COSTS,
                                       device=device)
    if res is None:
        raise AssertionError("an unbounded threshold always resolves")
    return res[0]


def levenshtein_exp(a: BytesLike, b: BytesLike, *, device=None) -> int:
    """Distance via exponential threshold search — much faster when the
    edit count is small (reference levenshtein.rs:1445-1454)."""
    k = 30
    while True:
        res = levenshtein_simd_k(a, b, k, device=device)
        if res is not None:
            return res
        k *= 2


def levenshtein_exp_with_opts(
    a: BytesLike,
    b: BytesLike,
    trace_on: bool = False,
    costs: EditCosts = LEVENSHTEIN_COSTS,
    *,
    device=None,
) -> Tuple[int, Optional[List[Edit]]]:
    """Exponential-search distance with options (reference levenshtein.rs:
    1480-1494)."""
    k = 30
    while True:
        res = levenshtein_simd_k_with_opts(a, b, k, trace_on, costs,
                                           device=device)
        if res is not None:
            return res
        k *= 2


def rdamerau_exp(a: BytesLike, b: BytesLike, *, device=None) -> int:
    """Exponential-search rdamerau distance (reference levenshtein.rs:
    1516-1526)."""
    k = 30
    while True:
        res = levenshtein_simd_k_with_opts(a, b, k, False, RDAMERAU_COSTS,
                                           device=device)
        if res is not None:
            return res[0]
        k *= 2


def levenshtein_exp_batch(
    a_batch: Sequence[BytesLike],
    b_batch: Sequence[BytesLike],
    costs: EditCosts = LEVENSHTEIN_COSTS,
    mesh=None,
    *,
    device=None,
) -> np.ndarray:
    """Batched exponential-search exact distance — the batched-first analog
    of `levenshtein_exp` (reference levenshtein.rs:1445-1454): all pairs
    start at k = 30; unresolved pairs retry together with k doubled, so a
    batch dominated by similar pairs never pays for a wide band.

    Returns int64 exact distances (always resolves; never -1).
    """
    dev = resolve_device(device)
    a_list = [to_bytes_array(x) for x in a_batch]
    b_list = [to_bytes_array(x) for x in b_batch]
    B = len(a_list)
    res = np.full(B, -1, dtype=np.int64)
    pending = np.arange(B)
    k = 30
    while pending.size:
        out = levenshtein_k_batch(
            [a_list[i] for i in pending],
            [b_list[i] for i in pending],
            k,
            costs,
            mesh=mesh,
            device=dev,
        )
        done = out >= 0
        res[pending[done]] = out[done]
        pending = pending[~done]
        k *= 2
    return res


def levenshtein_k_batch(
    a_batch: Sequence[BytesLike],
    b_batch: Sequence[BytesLike],
    k: int,
    costs: EditCosts = LEVENSHTEIN_COSTS,
    trace_on: bool = False,
    mesh=None,
    *,
    device=None,
):
    """Batched banded distance: the unit of work of the device.

    Computes the reference's `levenshtein_simd_k(a, b, k)` for every pair.
    Returns int64 distances with -1 where the pair's distance exceeds its
    (per-pair capped) threshold — the batched analog of the reference
    returning None.  One launch per (padded length, band) bucket.

    With `trace_on`, returns (dists, traces): traces[p] is the RLE edit
    list (None where dists[p] == -1): the band kernel emits argmin codes,
    which stay on the device, a batched walk follows every pair back from
    (m, n) at once, and only the compact edit streams reach the host.

    The ladder, and the path names in the dispatch log (the JAX package's
    names in brackets):
    * `myers` [`myers`]: unit costs, capped threshold <= 191, untraced;
    * `band` [`pallas`, untiled and tiled]: every other untraced batch
      whose band fits `lev_band.band_plan` (unit_k <= 4096; any length);
      `TRIPLE_ACCEL_TORCH_FORCE_PATH=band` [`pallas_band`] sends unit-cost
      batches here too;
    * `band_trace` [`trace_pallas`, `trace_tiled`]: traced batches, same
      plan, chunked on the batch axis by `_TRACE_CODE_BYTES_CAP`;
    * past the plan: NotImplementedError naming the JAX engine
      (`myers_chunked.blocked_distance_chunked` for unit and rDamerau
      costs, `search_flat.flat_distance` for the others, the
      `band_scan.band_trace_batch` scan walk for traces).
    `mesh=` is not ported.
    """
    from .ops.band_scan import decode_walked_batch, walk_packed_traceback
    from .ops.lev_band import (
        band_distance,
        band_plan,
        band_trace,
        prepare_band_tensors,
    )
    from .ops.myers_distance import (
        myers_distance,
        myers_plan,
        prepare_myers_inputs,
    )

    dev = resolve_device(device)
    if mesh is not None:
        raise _not_ported(
            "levenshtein_k_batch(mesh=...)",
            "parallel/sharded.py sharded_myers_distance",
        )

    a_list = [to_bytes_array(x) for x in a_batch]
    b_list = [to_bytes_array(x) for x in b_batch]
    if len(a_list) != len(b_list):
        raise ValueError("batch lengths differ")
    B = len(a_list)
    if B == 0:
        out0 = np.empty(0, dtype=np.int64)
        return (out0, []) if trace_on else out0

    # vectorized per-pair dispatch math (compute_max_k / compute_unit_k
    # element for element)
    la = np.fromiter((len(x) for x in a_list), np.int64, B)
    lb = np.fromiter((len(x) for x in b_list), np.int64, B)
    swaps_arr = la > lb
    m_len = np.where(swaps_arr, lb, la)
    n_len = np.where(swaps_arr, la, lb)
    mc_, gc_, sgc_ = costs.mismatch_cost, costs.gap_cost, costs.start_gap_cost
    cap2 = (m_len << 1) * gc_ + np.where(
        m_len == 0, 0, sgc_ + np.where(n_len == m_len, sgc_, 0)
    )
    max_ks = np.minimum(m_len * mc_, cap2)
    max_ks = np.minimum(
        k, max_ks + (n_len - m_len) * gc_ + np.where(n_len == m_len, 0, sgc_)
    )
    uks = np.minimum(np.maximum(max_ks - sgc_, 0) // gc_, n_len)
    feasible = (n_len - m_len) <= uks
    uks = np.where(feasible, uks, 0)
    unit_k = int(uks.max(initial=0))
    swaps: List[bool] = swaps_arr.tolist()
    # infeasible pairs (length gap exceeds the band) are replaced with
    # empty pairs so they neither widen the batch's band/max_m nor
    # overflow the band buffer; masked to -1 at the end anyway
    _empty = np.empty(0, dtype=np.uint8)
    feas_list = feasible.tolist()
    swapped_a = [
        (_empty if not feas_list[p]
         else (b_list[p] if swaps[p] else a_list[p]))
        for p in range(B)
    ]
    swapped_b = [
        (_empty if not feas_list[p]
         else (a_list[p] if swaps[p] else b_list[p]))
        for p in range(B)
    ]

    # --- per-bucket dispatch (the batched analog of the reference's
    # per-call Jewel-width dispatch, levenshtein.rs:766-823): one long or
    # distant outlier pair must not widen every pair's band and row count.
    # Pairs are grouped by their pow2-quantized (padded m, unit_k) key;
    # groups smaller than _MIN_BUCKET merge upward into the next key so
    # per-launch overhead stays amortized.
    if B > _MIN_BUCKET:
        def _rup2(v, minimum):
            vv = np.maximum(v, minimum)
            return (1 << np.ceil(np.log2(vv)).astype(np.int64))

        mq = _rup2(np.where(feasible, np.maximum(m_len, 1), 1), 8)
        ukq = _rup2(uks, 4)
        key_of = list(zip(mq.tolist(), ukq.tolist()))
        groups: dict = {}
        for p in range(B):
            groups.setdefault(key_of[p], []).append(p)
        merged: List[List[int]] = []
        carry: List[int] = []
        for key in sorted(groups):
            members = carry + groups[key]
            if len(members) < _MIN_BUCKET:
                carry = members
            else:
                merged.append(members)
                carry = []
        if carry:
            if merged:
                merged[-1].extend(carry)
            else:
                merged.append(carry)
        if len(merged) > 1:
            out = np.empty(B, dtype=np.int64)
            traces_all: List[Optional[List[Edit]]] = [None] * B
            for members in merged:
                sub = levenshtein_k_batch(
                    [a_list[p] for p in members],
                    [b_list[p] for p in members],
                    k, costs, trace_on, device=dev,
                )
                if trace_on:
                    sub, sub_traces = sub
                    for q, p in enumerate(members):
                        traces_all[p] = sub_traces[q]
                out[list(members)] = sub
            return (out, traces_all) if trace_on else out

    uk_dev = round_up_pow2(unit_k, 4)
    longest = max((len(a) for a in swapped_a), default=1)
    max_m = round_up_pow2(longest, 8)
    max_k = int(max_ks.max(initial=0))
    ct = _costs_tuple(costs)

    use_myers = (
        not trace_on
        and ct == _UNIT
        and forced_path() != "band"
        and myers_plan(max_k) is not None
    )
    if not use_myers:
        # the band kernel streams the strings and takes its sizes at run
        # time, so rows are padded to 16, not to a power of two
        rows = -(-max(longest, 1) // 16) * 16
        plan = band_plan(rows, uk_dev, trace_on)
        if plan is None:
            what = (f"a batch whose band half-width reaches {uk_dev} (the "
                    "band plan covers unit_k <= 4096)")
            if trace_on:
                raise _not_ported(
                    what + " with trace_on=True",
                    "ops/band_scan.py band_trace_batch (the chunked scan "
                    "walk)")
            if ct in (_UNIT, _RDAMERAU):
                raise _not_ported(
                    what, "ops/pallas/myers_chunked.py "
                    "blocked_distance_chunked")
            raise _not_ported(
                what, "ops/pallas/search_flat.py flat_distance")
        DispatchDecision(
            path="band_trace" if trace_on else "band",
            cost_bucket=select_cost_bucket(max_k),
            unit_k=uk_dev,
            max_k=max_k,
            padded_m=rows,
            padded_n=B,
        ).log("levenshtein_k_batch")
        if not trace_on:
            bargs = prepare_band_tensors(swapped_a, swapped_b, uk_dev, rows,
                                         device=dev)
            dist = band_distance(*bargs, unit_k=uk_dev, costs_t=ct)
            out = dist.cpu().numpy().astype(np.int64)
            return np.where(feasible & (out <= max_ks), out, -1)
        # traced: chunk the batch so one launch's codes stay under the cap
        b_cap = max(1, _TRACE_CODE_BYTES_CAP // plan["code_bytes_per_pair"])
        outs, seqs = [], []
        for lo in range(0, B, b_cap):
            hi = min(lo + b_cap, B)
            bargs = prepare_band_tensors(swapped_a[lo:hi], swapped_b[lo:hi],
                                         uk_dev, rows, device=dev)
            dist, codes = band_trace(*bargs, unit_k=uk_dev, costs_t=ct)
            seq, _steps = walk_packed_traceback(codes, *bargs, unit_k=uk_dev)
            del codes
            outs.append(dist.cpu().numpy().astype(np.int64))
            seqs.append(seq.cpu().numpy())
        out = np.concatenate(outs)
        out = np.where(feasible & (out <= max_ks), out, -1)
        decoded = decode_walked_batch(np.concatenate(seqs, axis=0), swaps)
        traces = [decoded[p] if out[p] >= 0 else None for p in range(B)]
        return out, traces

    DispatchDecision(
        path="myers",
        cost_bucket=select_cost_bucket(max_k),
        unit_k=uk_dev,
        max_k=max_k,
        padded_m=max_m,
        padded_n=B,
    ).log("levenshtein_k_batch")

    # the kernel takes k at run time, so the exact batch maximum stands in
    # for the JAX package's pow2-rounded static k; the per-pair band still
    # comes from the per-pair threshold
    margs = prepare_myers_inputs(
        swapped_a,
        swapped_b,
        max_k,
        max_m,
        ks=np.where(feasible, max_ks, max_k),
        device=dev,
    )
    distm = myers_distance(*margs, k=max_k)
    out = distm.cpu().numpy().astype(np.int64)
    return np.where(feasible & (out <= max_ks), out, -1)


# ---------------------------------------------------------------------------
# Search dispatcher
# ---------------------------------------------------------------------------

def postprocess_matches(
    dists: np.ndarray,
    lengths: np.ndarray,
    k: int,
    search_type: SearchType,
) -> List[Match]:
    """Turn per-end-position (distance, length) arrays into Match lists with
    the reference's streaming semantics (levenshtein.rs:1792-1835).

    `dists[i]` / `lengths[i]` describe the candidate ending after i haystack
    characters (i = 0 is the empty-prefix candidate).  Best mode: curr_k
    shrinks as candidates stream, a candidate replaces the previous one if
    it fully overlaps it (start <= previous start), and only k == final
    curr_k entries survive.

    Uses the native C++ pass (native/postprocess.cpp) when built; falls
    back to NumPy.
    """
    from .utils.native import postprocess_matches_native

    native = postprocess_matches_native(
        np.asarray(dists), np.asarray(lengths), k,
        search_type == SearchType.Best,
    )
    if native is not None:
        return native

    hits = np.flatnonzero(dists <= k)
    return _postprocess_sparse(
        [(int(i), int(dists[i]), int(lengths[i])) for i in hits],
        k, search_type,
    )


def _empty_needle_matches(
    haystack_len: int, k: int, search_type: SearchType, costs: EditCosts,
    anchored: bool,
) -> List[Match]:
    """Empty-needle special cases (reference levenshtein.rs:1600-1644,
    1919-1963)."""
    if not anchored:
        return []
    if search_type == SearchType.Best:
        return [Match(start=0, end=0, k=0)]
    res = [Match(start=0, end=0, k=0)]
    cost = costs.start_gap_cost
    for i in range(1, haystack_len + 1):
        cost += costs.gap_cost
        if cost > k:
            break
        res.append(Match(start=0, end=i, k=cost))
    return res


def _merge_hit_windows(gpos: np.ndarray, span: int):
    """Merge the per-hit replay windows [p - span, p) of sorted hit end
    positions into disjoint char intervals [starts[i], ends[i]).  A
    cost-<=k candidate ending at p spans at most `span` chars, so an
    interval containing each hit's window replays it exactly."""
    gpos = np.asarray(gpos, dtype=np.int64)
    starts_all = np.maximum(gpos - span, 0)
    brk = np.flatnonzero(starts_all[1:] > gpos[:-1]) + 1
    gs = np.concatenate([[0], brk])
    ge = np.concatenate([brk, [gpos.size]])
    return starts_all[gs], gpos[ge - 1]


# host-time guard for the streaming replay: total DP cells (interval chars
# x needle len) the batched C++ resolution may burn; past it the JAX
# package recovers lengths on the device with its flat engine
_RESOLVE_CELLS_BUDGET = 300_000_000


def _resolve_hits_batch(
    needle: np.ndarray,
    haystack: np.ndarray,
    gpos: np.ndarray,
    k: int,
    costs: EditCosts,
    span: int,
) -> List[Tuple[int, int, int]]:
    """Resolve kernel hits (sorted end positions, device dist <= k) into
    authoritative (end, dist, length) candidates in ONE batched replay.

    The per-hit windows merge into disjoint intervals (dense hit streams
    collapse into a single streaming pass) and the C++ oracle port runs
    the All-mode search DP over all of them in one call
    (native/scalar_baseline.cpp ta_search_intervals).  The replay is
    authoritative for distance and length — the oracle IS the tie-break
    semantics (jewel.rs:364-417) — and a hit it does not confirm is
    dropped.  The Python oracle replays the same intervals when the native
    library is not built: the same semantics on the host."""
    from .utils.native import search_intervals_native

    if gpos.size == 0:
        return []
    gpos = np.asarray(gpos, dtype=np.int64)
    istarts, iends = _merge_hit_windows(gpos, span)
    native = search_intervals_native(needle, haystack, istarts, iends, k,
                                     costs)
    if native is not None:
        ends, ks, lens = native
    else:
        e_l: List[int] = []
        k_l: List[int] = []
        l_l: List[int] = []
        for s, e in zip(istarts.tolist(), iends.tolist()):
            for mt in levenshtein_search_naive_with_opts(
                needle, haystack[s:e], k, SearchType.All, costs, False
            ):
                e_l.append(s + mt.end)
                k_l.append(mt.k)
                l_l.append(mt.end - mt.start)
        ends = np.asarray(e_l, dtype=np.int64)
        ks = np.asarray(k_l, dtype=np.int64)
        lens = np.asarray(l_l, dtype=np.int64)
    return _select_hit_candidates(ends, ks, lens, gpos)


def _select_hit_candidates(
    ends: np.ndarray, ks: np.ndarray, lens: np.ndarray, gpos: np.ndarray
) -> List[Tuple[int, int, int]]:
    """Keep only the replay candidates at the requested (unique, ascending)
    hit end positions; replay candidates have unique ascending ends."""
    if ends.size == 0:
        return []
    idx = np.searchsorted(ends, gpos)
    idx_c = np.minimum(idx, ends.size - 1)
    hit = ends[idx_c] == gpos
    sel = idx_c[hit]
    return list(zip(gpos[hit].tolist(), ks[sel].tolist(),
                    lens[sel].tolist()))


def _resolve_hits_anchored(
    needle: np.ndarray,
    haystack: np.ndarray,
    gpos: np.ndarray,
    k: int,
    costs: EditCosts,
) -> List[Tuple[int, int, int]]:
    """Resolve ANCHORED kernel hits into (end, dist, length) candidates.

    The anchored DP's row-0 boundary is the absolute haystack prefix cost,
    so windowed replays don't apply — instead one All-mode anchored replay
    over the haystack recovers every candidate (the C++ port caps its own
    iteration at needle_len + (k - start_gap) / gap columns, mirroring
    reference levenshtein.rs:1650-1661)."""
    from .utils.native import search_all_native

    if gpos.size == 0:
        return []
    gpos = np.asarray(gpos, dtype=np.int64)
    native = search_all_native(needle, haystack, k, costs, anchored=True)
    if native is not None:
        ends, ks, lens = native
    else:
        mts = levenshtein_search_naive_with_opts(
            needle, haystack, k, SearchType.All, costs, True
        )
        ends = np.asarray([mt.end for mt in mts], dtype=np.int64)
        ks = np.asarray([mt.k for mt in mts], dtype=np.int64)
        lens = np.asarray([mt.end - mt.start for mt in mts], dtype=np.int64)
    return _select_hit_candidates(ends, ks, lens, gpos)


def _resolve_cells(gpos: np.ndarray, span: int, m: int) -> int:
    """DP cells the batched replay would burn for these hits."""
    if gpos.size == 0:
        return 0
    istarts, iends = _merge_hit_windows(gpos, span)
    return int((iends - istarts).sum()) * max(m, 1)


def _postprocess_sparse(
    cands: List[Tuple[int, int, int]],  # (end, dist, length), end-ascending
    k: int,
    search_type: SearchType,
) -> List[Match]:
    """postprocess_matches over a sparse candidate list (all dist <= k);
    behaviorally identical because the dense pass only inspects hits."""
    if search_type == SearchType.All:
        return [Match(start=p - l, end=p, k=d) for p, d, l in cands]
    res: List[Match] = []
    curr_k = k
    for p, d, l in cands:
        if d <= curr_k:
            curr_k = d
            mt = Match(start=p - l, end=p, k=d)
            if res and mt.start <= res[-1].start:
                res[-1] = mt
            else:
                res.append(mt)
    return [mt for mt in res if mt.k == curr_k]


def levenshtein_search_simd_with_opts(
    needle: BytesLike,
    haystack: BytesLike,
    k: int,
    search_type: SearchType = SearchType.Best,
    costs: EditCosts = LEVENSHTEIN_COSTS,
    anchored: bool = False,
    *,
    device=None,
) -> List[Match]:
    """Device-accelerated approximate search (reference levenshtein.rs:
    1911-2155).

    The Myers search kernel computes the distance of every end position
    over the raw haystack on the device; only the hits (distance <= k)
    come back, and the host recovers each hit's match length — the
    reference's maximize-length tie-break — by replaying the scalar search
    over the hit windows, then applies the Best / All / overlap rules.
    Long haystacks run as parallel segments with a halo of one window
    span, which is exact for every candidate with cost <= k.

    Ported: unit and restricted-Damerau costs, anchored or not, needles of
    1..1280 chars.  A needle of a given length always takes the same
    engine, on the CPU and on the card.
    """
    from .ops.myers_search import (
        collect_hits,
        myers_search,
        myers_search_plan,
        prepare_myers_needles,
        suggest_own_len,
    )
    from .ops.search_common import window_span
    from .utils.native import native_available

    dev = resolve_device(device)
    needle = to_bytes_array(needle)
    haystack = to_bytes_array(haystack)
    m, n = len(needle), len(haystack)

    if m == 0:
        return _empty_needle_matches(n, k, search_type, costs, anchored)

    costs.check_search()

    if forced_path() == "oracle":
        return levenshtein_search_naive_with_opts(
            needle, haystack, k, search_type, costs, anchored
        )

    ct = _costs_tuple(costs)
    damerau = ct == _RDAMERAU
    if not (ct == _UNIT or damerau):
        raise _not_ported(
            f"levenshtein_search_simd_with_opts with costs {ct}",
            "ops/pallas/search_kernel.py search_pallas and "
            "ops/pallas/search_flat.py flat_search",
        )
    if myers_search_plan(m) is None:
        raise _not_ported(
            f"a search needle of {m} chars (the Myers search plan covers "
            "<= 1280)",
            "ops/pallas/search_myers.py blocked_search_pallas and "
            "ops/pallas/myers_chunked.py blocked_search_chunked",
        )

    span = min(window_span(m, k, costs.gap_cost, costs.start_gap_cost), n)
    if anchored:
        # anchored searches run as ONE segment starting at the anchor
        # (halo = 0; a segment boundary would break the absolute row-0
        # cost D[0][j] = j); iter_len is capped at m + k columns
        iter_len = min(
            m + max(0, k - costs.start_gap_cost) // costs.gap_cost, n
        )
        halo = 0
        own_len = max(iter_len, 1)
    else:
        iter_len = n
        # quantized like the JAX package's: a larger overlap is still
        # exact — every cost-<=k candidate's window is contained a fortiori
        halo = min(-(-span // 256) * 256, iter_len)
        own_len = suggest_own_len(iter_len, halo)
    DispatchDecision(
        path="myers_search_rdamerau" if damerau else "myers_search",
        cost_bucket="u8",
        unit_k=halo,
        max_k=k,
        padded_m=m,
        padded_n=halo + own_len,
    ).log("levenshtein_search_simd_with_opts")

    # the RAW haystack is the only large host->device transfer; segments
    # read their own halo from it, and only the hits come back
    hay_np = np.ascontiguousarray(haystack[:iter_len])
    if not hay_np.flags.writeable:  # torch refuses read-only buffers
        hay_np = hay_np.copy()
    hay_d = torch.from_numpy(hay_np).to(dev)
    needles_d = prepare_myers_needles([needle], m, device=dev)
    dist = myers_search(hay_d, needles_d, own_len=own_len, halo=halo,
                        anchored=anchored, damerau=damerau)
    _, gpos, d_arr = collect_hits(dist, min(k, (1 << 31) - 1))
    del dist
    # segment 0 starts at byte 0 with a fresh state, so there is no
    # synthetic front pad a NUL needle byte could match: kernel distances
    # <= k are exact as they are

    if search_type == SearchType.Best and gpos.size:
        # Best-mode results can only contain candidates at the global
        # minimum cost (the streaming pass keeps k == final curr_k,
        # reference levenshtein.rs:1812-1835) — so only those need the
        # length resolution, dense or not
        at_min = d_arr == int(d_arr.min())
        gpos, d_arr = gpos[at_min], d_arr[at_min]
    if anchored:
        # one anchored All-mode replay recovers every hit's length; it
        # costs the same O(m * iter_len) DP work as the whole anchored
        # search, so no budget applies
        cands = _resolve_hits_anchored(needle, haystack, gpos, k, costs)
        return _postprocess_sparse(cands, k, search_type)
    budget = _RESOLVE_CELLS_BUDGET
    if not native_available():
        budget //= 100  # the Python replay is about 100x slower
    if _resolve_cells(gpos, span, m) > budget:
        raise _not_ported(
            "length resolution of a degenerate-dense hit stream (over the "
            "host replay budget)",
            "levenshtein._resolve_hits_flat over ops/pallas/search_flat.py "
            "flat_search_gather_selected",
        )
    cands = _resolve_hits_batch(needle, haystack, gpos, k, costs, span)
    return _postprocess_sparse(cands, k, search_type)


def levenshtein_search_simd(needle: BytesLike, haystack: BytesLike, *,
                            device=None) -> List[Match]:
    """Default device search: k = ceil(len/2), Best, unit costs, unanchored
    (reference levenshtein.rs:1866-1878)."""
    needle = to_bytes_array(needle)
    return levenshtein_search_simd_with_opts(
        needle,
        haystack,
        default_search_k(len(needle)),
        SearchType.Best,
        LEVENSHTEIN_COSTS,
        False,
        device=device,
    )


def levenshtein_search(needle: BytesLike, haystack: BytesLike, *,
                       device=None) -> List[Match]:
    """Blessed search entry point (reference levenshtein.rs:2508-2510)."""
    return levenshtein_search_simd(needle, haystack, device=device)


# ---------------------------------------------------------------------------
# Names of the JAX package that the port does not carry yet
# ---------------------------------------------------------------------------

def levenshtein_search_many(*args, **kwargs):
    """Dictionary search (many needles, one resident haystack): not ported."""
    raise _not_ported(
        "levenshtein_search_many",
        "levenshtein.levenshtein_search_many over the multi-needle grid of "
        "ops/pallas/search_myers.py myers_search_pallas",
    )


def levenshtein_search_sharded(*args, **kwargs):
    """Search over a haystack sharded across devices: not ported."""
    raise _not_ported(
        "levenshtein_search_sharded",
        "parallel/sharded.py sharded_myers_search_mins with ppermute halo "
        "exchange",
    )


class PackedHaystack:
    """Device-resident packed haystack for dictionary search: not ported."""

    def __init__(self, *args, **kwargs):
        raise _not_ported(
            "PackedHaystack",
            "levenshtein.PackedHaystack over ops/pallas/search_myers.py "
            "device_pack_segs",
        )
