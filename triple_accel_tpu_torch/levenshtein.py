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
  the batched traceback walk (ops/trace_walk.py, kernel K10, which emits
  runs) and their decode (ops/band_scan.py);
* `band_trace_global` — traced batches past that band plan: the traced
  band kernel's cluster regime (one pair a thread-block cluster, the
  matrix's columns in registers) or, for b strings longer than a cluster
  holds, its device-memory regime, then the same walk and decode;
* `myers_blocked_distance` — the same entry points past the band plan
  with unit or restricted-Damerau costs, untraced: exact distances of
  pairs of any length (ops/myers_chunked.py, kernel K5), so `levenshtein`
  and `rdamerau` take strings of any length;
* `flat_distance` — the same entry points past the band plan with any other
  cost model (and unit costs under TRIPLE_ACCEL_TORCH_FORCE_PATH=band), untraced:
  the row-oriented general-cost distance banded by the threshold
  (ops/search_flat.py, kernel K9);
* `myers_search` / `myers_search_rdamerau` — `levenshtein_search_simd_with_opts`
  and its wrappers, unit and restricted-Damerau costs, anchored or not,
  needles up to 1280 chars (ops/myers_search.py), and `myers_search_blocked`
  for longer needles (ops/myers_chunked.py, kernel K6), each followed by
  the hit fetch and the All-mode length replay on the host, or, for a hit
  stream past the replay budget, `flat_resolve`: kernel K8 over only the
  segments that hold hits;
* `search_diag` / `flat_search` — the same search entry points under any
  other cost model: needles up to 512 chars on the diagonal kernel
  (ops/search_diag.py, K7), longer ones on the row kernel
  (ops/search_flat.py, K8), both with the match lengths on the device.

Every other route of the JAX package (meshes, dictionary search, sharded
search) raises `NotImplementedError` naming the JAX engine that is still to
be ported.  Nothing falls back to the oracle, the plain
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

# bytes of packed argmin codes and of the walk's run buffer (4 bytes a
# step) one traced launch may hold on the device: larger traced batches
# chunk on the batch axis (pairs walk independently).
# 16 GiB, a fifth of the H100's 80 GB: past the band plan the kernel runs
# one pair a cluster of a few SMs, so a chunk must hold a hundred pairs or
# so to fill the card, and 128 pairs of 10,000 bytes at unit_k 10,064 hold
# 50 MB of codes each (6.4 GB; a 1 GiB cap would cut them into chunks of
# 21).  The kernels and the walk index the codes with int64, so no batch
# overflows an index.
_TRACE_CODE_BYTES_CAP = 16 << 30

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
    kept as the scalar check of the batched walk).  Untraced unit and
    restricted-Damerau thresholds past the band plan take the blocked
    Myers distance kernel and other cost models the row-oriented flat
    distance kernel, traced ones the band kernel with its state in device
    memory, so any string length resolves.
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
    """Banded distance (reference levenshtein.rs:677-684); any length and
    threshold (past the band plan on the blocked Myers kernel)."""
    res = levenshtein_simd_k_with_opts(a, b, k, False, LEVENSHTEIN_COSTS,
                                       device=device)
    return None if res is None else res[0]


def levenshtein(a: BytesLike, b: BytesLike, *, device=None) -> int:
    """Exact Levenshtein distance (reference levenshtein.rs:1397-1399).
    The threshold is unbounded, so the band is about the string length:
    pairs whose capped threshold passes 191 take the general band kernel,
    and pairs past its plan (band half-width over 4096, strings longer
    than about 4,100 chars) the blocked Myers distance kernel: any
    length."""
    res = levenshtein_simd_k(a, b, U32_MAX, device=device)
    if res is None:
        raise AssertionError("an unbounded threshold always resolves")
    return res


def rdamerau(a: BytesLike, b: BytesLike, *, device=None) -> int:
    """Exact restricted Damerau-Levenshtein distance (reference
    levenshtein.rs:1419-1423), on the general band kernel, and past its
    plan (band half-width over 4096) on the blocked Myers distance kernel:
    any length."""
    res = levenshtein_simd_k_with_opts(a, b, U32_MAX, False, RDAMERAU_COSTS,
                                       device=device)
    if res is None:
        raise AssertionError("an unbounded threshold always resolves")
    return res[0]


def levenshtein_exp(a: BytesLike, b: BytesLike, *, device=None) -> int:
    """Distance via exponential threshold search — much faster when the
    edit count is small (reference levenshtein.rs:1445-1454).  A threshold
    past the band plan takes the blocked Myers kernel: any length."""
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
    1480-1494).  Every cost model resolves at any length: past the band
    plan untraced searches take the blocked Myers kernel or the flat
    distance kernel for general costs, traced ones the band kernel's
    cluster regime (or, for the longest strings, its device-memory
    regime)."""
    k = 30
    while True:
        res = levenshtein_simd_k_with_opts(a, b, k, trace_on, costs,
                                           device=device)
        if res is not None:
            return res
        k *= 2


def rdamerau_exp(a: BytesLike, b: BytesLike, *, device=None) -> int:
    """Exponential-search rdamerau distance (reference levenshtein.rs:
    1516-1526); any length (past the band plan on the blocked Myers
    kernel)."""
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
    batch dominated by similar pairs never pays for a wide band.  Rungs
    past the band plan take the blocked Myers kernel (unit and
    restricted-Damerau costs) or the flat distance kernel (other costs),
    so pairs of any length resolve.

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
    (m, n) at once, and only its runs of equal steps reach the host.

    The ladder, and the path names in the dispatch log (the JAX package's
    names in brackets):
    * `myers` [`myers`]: unit costs, capped threshold <= 191, untraced;
    * `band` [`pallas`, untiled and tiled]: every other untraced batch
      whose band fits `lev_band.band_plan` (unit_k <= 4096; any length);
      `TRIPLE_ACCEL_TORCH_FORCE_PATH=band` [`pallas_band`] sends unit-cost
      batches here too;
    * `band_trace` [`trace_pallas`, `trace_tiled`]: traced batches, same
      plan, chunked on the batch axis by `_TRACE_CODE_BYTES_CAP`; the walk
      is kernel K10 (ops/trace_walk.py);
    * `band_trace_global` [`trace_batch`]: traced batches past the plan
      (band state past a block's shared memory: unit_k > 4,640 at the
      16-rounding, up to `lev_band.MAX_TRACE_UNIT_K`): the traced band
      kernel's cluster regime, past `lev_band.CLUSTER_MAX_COLUMNS` its
      device-memory regime (`band_plan` picks), chunked and walked the
      same way; traced batches run at their unit_k rounded up to 16;
    * `myers_blocked_distance` [`myers_blocked_distance`]: untraced batches
      past the plan under unit or restricted-Damerau costs: the exact
      full-matrix bit-vector distance of pairs of any length
      (ops/myers_chunked.py), `-1` above the capped threshold;
    * `flat_distance` [`flat_distance`]: untraced batches past the plan
      under any other cost model, and unit costs under FORCE_PATH=band, as
      in the JAX package: the row-oriented distance banded by the batch's
      unit_k (ops/search_flat.py, kernel K9), a batch whose per-row edges
      pass `search_flat.EDGE_BYTES_CAP` in several launches.  The JAX
      package chose between this kernel and its banded `lax.scan` by time
      models measured on a v5e (`_flat_beats_scan`); here that scan is
      only the plain version, so there is nothing to choose between and
      the guard is not ported.
    `mesh=` is not ported.
    """
    from .ops.band_scan import decode_walked_batch
    from .ops.lev_band import (
        MAX_TRACE_UNIT_K,
        band_distance,
        band_plan,
        band_trace,
        prepare_band_tensors,
    )
    from .ops.myers_chunked import (
        blocked_distance,
        prepare_blocked_distance_inputs,
    )
    from .ops.myers_distance import (
        myers_distance,
        myers_plan,
        prepare_myers_inputs,
    )
    from .ops.search_flat import flat_distance, prepare_flat_distance_inputs
    from .ops.trace_walk import run_bytes_per_pair, trace_walk

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
    # a negative threshold admits no pair (max_ks < 0): the reference's
    # -1 / None, and no negative per-pair k reaches a kernel
    feasible = ((n_len - m_len) <= uks) & (max_ks >= 0)
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

    # the kernels take unit_k at run time: a traced batch runs K4 and K10
    # at its unit_k rounded up to 16 (a word of codes), not to the JAX
    # package's power of two, so no cell is computed and no code word
    # stored that a trace within the threshold cannot reach (a cell at
    # |j - i| > unit_k costs more than max_ks); the untraced engines keep
    # the power of two
    uk_dev = (-(-unit_k // 16) * 16 if trace_on
              else round_up_pow2(unit_k, 4))
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
        plan = band_plan(rows, uk_dev, trace_on,
                         max_n=max((len(b) for b in swapped_b), default=0))
        if plan is None and trace_on:
            raise ValueError(
                f"a traced batch whose band half-width reaches {uk_dev}: "
                f"the traced band kernel takes unit_k <= {MAX_TRACE_UNIT_K}")
        if plan is None:
            if ct not in (_UNIT, _RDAMERAU) or forced_path() == "band":
                # any cost model: the row kernel, banded by the batch's
                # unit_k (exact for every pair within its threshold)
                DispatchDecision(
                    path="flat_distance",
                    cost_bucket=select_cost_bucket(max_k),
                    unit_k=uk_dev,
                    max_k=max_k,
                    padded_m=max_m,
                    padded_n=B,
                ).log("levenshtein_k_batch")
                fargs = prepare_flat_distance_inputs(swapped_a, swapped_b,
                                                     device=dev)
                dist = flat_distance(*fargs, costs_t=ct, unit_k=uk_dev)
                out = dist.cpu().numpy().astype(np.int64)
                return np.where(feasible & (out <= max_ks), out, -1)
            # unit and rDamerau costs: the full-matrix bit-vector distance
            # of any length (the reference's own headline call shape,
            # levenshtein.rs:1397-1423 over its unbounded band)
            DispatchDecision(
                path="myers_blocked_distance",
                cost_bucket=select_cost_bucket(max_k),
                unit_k=uk_dev,
                max_k=max_k,
                padded_m=max_m,
                padded_n=B,
            ).log("levenshtein_k_batch")
            bargs = prepare_blocked_distance_inputs(swapped_a, swapped_b,
                                                    device=dev)
            dist = blocked_distance(*bargs, damerau=ct == _RDAMERAU)
            out = dist.cpu().numpy().astype(np.int64)
            # empty-a pairs come back 0 from the kernel: D[0][n] = n gaps
            out = np.where(m_len == 0, n_len, out)
            return np.where(feasible & (out <= max_ks), out, -1)
        path = "band"
        if trace_on:
            path = ("band_trace" if plan["regime"] in ("warp", "wide")
                    else "band_trace_global")
        DispatchDecision(
            path=path,
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
        # traced: chunk the batch so one launch's codes and the walk's run
        # buffer stay under the cap; the chunks' runs join end to end
        b_cap = max(1, _TRACE_CODE_BYTES_CAP // (
            plan["code_bytes_per_pair"] + run_bytes_per_pair(rows, uk_dev)))
        outs, runs, counts = [], [], []
        for lo in range(0, B, b_cap):
            hi = min(lo + b_cap, B)
            bargs = prepare_band_tensors(swapped_a[lo:hi], swapped_b[lo:hi],
                                         uk_dev, rows, device=dev)
            dist, codes = band_trace(
                *bargs, unit_k=uk_dev, costs_t=ct,
                max_n=max((len(b) for b in swapped_b[lo:hi]), default=0))
            r, c = trace_walk(codes, *bargs, unit_k=uk_dev)
            del codes
            outs.append(dist.cpu().numpy().astype(np.int64))
            runs.append(r.cpu().numpy())
            counts.append(c.cpu().numpy())
        out = np.concatenate(outs)
        out = np.where(feasible & (out <= max_ks), out, -1)
        # only the pairs within the threshold are decoded
        traces = decode_walked_batch(np.concatenate(runs),
                                     np.concatenate(counts), swaps,
                                     keep=out >= 0)
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
# x needle len) the batched C++ resolution may burn; past it the lengths
# are recovered on the device by the flat search kernel
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


def _resolve_hits_flat(
    needle: np.ndarray,
    hay_d: torch.Tensor,
    gpos: np.ndarray,
    k: int,
    costs: EditCosts,
    span: int,
) -> List[Tuple[int, int, int]]:
    """Length resolution of a degenerate-dense hit stream ON THE DEVICE
    (the JAX package's `_resolve_hits_flat`): the flat search kernel,
    which tracks match lengths in its DP, reruns ONLY the segments that
    hold hits, and 8 bytes a hit come back.  Work is proportional to the
    hit-bearing part of the haystack and the host replay's cost never
    applies.  `hay_d` is the haystack already on the device.  The end-0
    candidate is (m*gap + start_gap, 0) by definition."""
    from .ops.search_flat import (
        flat_search,
        prepare_flat_needle,
        suggest_own_len_flat,
    )

    if gpos.size == 0:
        return []
    m = len(needle)
    iter_len = hay_d.shape[0]
    gpos = np.asarray(gpos, np.int64)
    halo = min(span, iter_len)
    own_len = suggest_own_len_flat(iter_len, halo,
                                   transpose=costs.allow_transpose)
    pos = gpos[gpos > 0]
    c_of = (pos - 1) // own_len
    c_sel, x_of = np.unique(c_of, return_inverse=True)
    DispatchDecision(
        path="flat_resolve",
        cost_bucket=select_cost_bucket(min(k, U32_MAX)),
        unit_k=halo,
        max_k=k,
        padded_m=m,
        padded_n=halo + own_len,
    ).log("_resolve_hits_flat")
    cands: List[Tuple[int, int, int]] = []
    d0 = m * costs.gap_cost + costs.start_gap_cost
    if gpos[0] == 0 and d0 <= k:
        cands.append((0, d0, 0))
    if pos.size:
        needle_d = prepare_flat_needle(needle, device=hay_d.device)
        dist, length = flat_search(
            hay_d, needle_d, own_len=own_len, halo=halo,
            costs_t=_costs_tuple(costs),
            segments=torch.from_numpy(c_sel).to(hay_d.device))
        x_d = torch.from_numpy(x_of).to(hay_d.device)
        o_d = torch.from_numpy(pos - c_of * own_len - 1).to(hay_d.device)
        dd = dist[x_d, o_d].cpu().numpy().astype(np.int64)
        ll = length[x_d, o_d].cpu().numpy().astype(np.int64)
        keep = dd <= k
        cands.extend(zip(pos[keep].tolist(), dd[keep].tolist(),
                         ll[keep].tolist()))
    return cands


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


def _search_iter_len(m: int, n: int, k: int, costs: EditCosts,
                     anchored: bool) -> int:
    """Haystack bytes a search reads: all of them, or, anchored, the
    m + k columns an anchored match can end in (the reference's own cap,
    levenshtein.rs:1650-1661)."""
    if anchored:
        return min(m + max(0, k - costs.start_gap_cost) // costs.gap_cost, n)
    return n


def _upload_haystack(haystack: np.ndarray, dev: torch.device) -> torch.Tensor:
    """The RAW haystack on `dev`: the only large host->device transfer of a
    search (segments read their own halo from it, and only the hits come
    back), at a 16-byte aligned address as the kernels read it."""
    from .ops.myers_search import _aligned

    hay_np = np.ascontiguousarray(haystack)
    if not hay_np.flags.writeable:  # torch refuses read-only buffers
        hay_np = hay_np.copy()
    return _aligned(torch.from_numpy(hay_np).to(dev))


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

    Unit and restricted-Damerau costs: needles of up to
    `myers_search.ROUTE_MAX_NEEDLE` chars (352 unit, 288 rDamerau: where
    it stops beating the blocked kernel on the card) take the Myers search
    kernel (ops/myers_search.py), longer ones the blocked one
    (ops/myers_chunked.py, logged `myers_search_blocked`), which serves
    both long-needle engines of the JAX package, `myers_search_blocked`
    and `myers_search_chunked`, at any halo.  A hit stream whose replay
    would pass `_RESOLVE_CELLS_BUDGET` gets its lengths from the flat
    search kernel over the hit-bearing segments (`flat_resolve`).

    Any other cost model (the dispatch log's names, the JAX package's in
    brackets): needles of 1..512 chars take the diagonal kernel, K7
    (`search_diag` [`pallas`], ops/search_diag.py), longer ones the row
    kernel, K8 (`flat_search` [`flat_search`], ops/search_flat.py),
    anchored or not.  Both return the match lengths with the distances,
    so only the hits come back and no replay runs.  A needle of a given
    length always takes the same engine, on the CPU and on the card.

    The call uploads the haystack (an anchored one only up to where an
    anchored match can end), then runs the engines' second part on it
    (`_search_resident`); `levenshtein_search_many` runs the same second
    part on a haystack uploaded once for many needles.
    """
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
    if not (ct == _UNIT or ct == _RDAMERAU):
        return _search_general(needle, haystack, k, search_type, costs,
                               anchored, dev)
    iter_len = _search_iter_len(m, n, k, costs, anchored)
    hay_d = _upload_haystack(haystack[:iter_len], dev)
    return _search_myers_resident(needle, haystack, hay_d, k, search_type,
                                  costs, anchored)


def _search_resident(needle: np.ndarray, haystack: np.ndarray,
                     hay_d: torch.Tensor, k: int, search_type: SearchType,
                     costs: EditCosts, anchored: bool) -> List[Match]:
    """`levenshtein_search_simd_with_opts` for a needle of at least one
    char over a haystack already on the device: `hay_d` holds at least the
    bytes the search reads (`_search_iter_len`), `haystack` is the same
    bytes on the host (the length replay reads them)."""
    ct = _costs_tuple(costs)
    if ct == _UNIT or ct == _RDAMERAU:
        return _search_myers_resident(needle, haystack, hay_d, k,
                                      search_type, costs, anchored)
    return _search_general_resident(needle, haystack, hay_d, k, search_type,
                                    costs, anchored)


def _myers_search_plan(m: int, n: int, k: int, costs: EditCosts,
                       anchored: bool):
    """(engine, span, iter_len, halo, own_len) of a unit or
    restricted-Damerau search: the one plan both the single call and a
    dictionary group use, so a dictionary needle's kernel row equals its
    single call's.  `engine` is the dispatch log's name."""
    from .ops.myers_chunked import suggest_own_len_blocked
    from .ops.myers_search import ROUTE_MAX_NEEDLE, search_halo, suggest_own_len
    from .ops.search_common import window_span

    damerau = _costs_tuple(costs) == _RDAMERAU
    blocked = m > ROUTE_MAX_NEEDLE[damerau]
    span = min(window_span(m, k, costs.gap_cost, costs.start_gap_cost), n)
    iter_len = _search_iter_len(m, n, k, costs, anchored)
    if anchored:
        # anchored searches run as ONE segment starting at the anchor
        # (halo = 0; a segment boundary would break the absolute row-0
        # cost D[0][j] = j); iter_len is capped at m + k columns
        halo = 0
        own_len = max(iter_len, 1)
    # a larger overlap than the span is still exact: every cost-<=k
    # candidate's window is contained a fortiori.  K2 rounds the span to
    # its 32-byte sectors; K6 keeps the JAX package's quantum of 256,
    # which its own_len rule was measured at
    elif blocked:
        halo = min(-(-span // 256) * 256, iter_len)
        own_len = suggest_own_len_blocked(iter_len, halo)
    else:
        halo = search_halo(span, iter_len)
        own_len = suggest_own_len(iter_len, halo)
    if blocked:
        engine = "myers_search_blocked"
    else:
        engine = "myers_search_rdamerau" if damerau else "myers_search"
    return engine, span, iter_len, halo, own_len


def _search_myers_resident(needle: np.ndarray, haystack: np.ndarray,
                           hay_d: torch.Tensor, k: int,
                           search_type: SearchType, costs: EditCosts,
                           anchored: bool) -> List[Match]:
    """The unit / restricted-Damerau half of `_search_resident`: K2 (or K6
    past `ROUTE_MAX_NEEDLE`), the hit fetch, then `_hits_to_matches`."""
    from .ops.myers_chunked import blocked_search
    from .ops.myers_search import (
        collect_hits,
        myers_search,
        prepare_myers_needles,
    )

    m, n = len(needle), len(haystack)
    damerau = _costs_tuple(costs) == _RDAMERAU
    engine, span, iter_len, halo, own_len = _myers_search_plan(
        m, n, k, costs, anchored)
    DispatchDecision(
        path=engine,
        cost_bucket="u8",
        unit_k=halo,
        max_k=k,
        padded_m=m,
        padded_n=halo + own_len,
    ).log("levenshtein_search_simd_with_opts")

    needles_d = prepare_myers_needles([needle], m, device=hay_d.device)
    search = (blocked_search if engine == "myers_search_blocked"
              else myers_search)
    dist = search(hay_d[:iter_len], needles_d, own_len=own_len, halo=halo,
                  anchored=anchored, damerau=damerau)
    _, gpos, d_arr = collect_hits(dist, min(k, (1 << 31) - 1))
    del dist
    # segment 0 starts at byte 0 with a fresh state, so there is no
    # synthetic front pad a NUL needle byte could match: kernel distances
    # <= k are exact as they are
    return _hits_to_matches(needle, haystack, hay_d, gpos, d_arr, k,
                            search_type, costs, anchored, span)


def _hits_to_matches(needle: np.ndarray, haystack: np.ndarray,
                     hay_d: torch.Tensor, gpos: np.ndarray, d_arr: np.ndarray,
                     k: int, search_type: SearchType, costs: EditCosts,
                     anchored: bool, span: int) -> List[Match]:
    """One needle's kernel hits (sorted end positions, distances <= k) to
    its Match list: Best's filter, the length resolution, the Best / All
    rules."""
    from .utils.native import native_available

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
    if _resolve_cells(gpos, span, len(needle)) > budget:
        # degenerate-dense hit stream: the lengths come from the flat
        # kernel on the device, over the hit-bearing segments only
        cands = _resolve_hits_flat(needle, hay_d, gpos, k, costs, span)
    else:
        cands = _resolve_hits_batch(needle, haystack, gpos, k, costs, span)
    return _postprocess_sparse(cands, k, search_type)


def _search_general(needle: np.ndarray, haystack: np.ndarray, k: int,
                    search_type: SearchType, costs: EditCosts,
                    anchored: bool, dev: torch.device) -> List[Match]:
    """Search under a cost model other than unit or restricted-Damerau
    (the JAX package's `levenshtein.py:1838-1981`): the upload, then
    `_search_general_resident`."""
    iter_len = _search_iter_len(len(needle), len(haystack), k, costs,
                                anchored)
    hay_d = _upload_haystack(haystack[:iter_len], dev)
    return _search_general_resident(needle, haystack, hay_d, k, search_type,
                                    costs, anchored)


def _search_general_resident(needle: np.ndarray, haystack: np.ndarray,
                             hay_d: torch.Tensor, k: int,
                             search_type: SearchType, costs: EditCosts,
                             anchored: bool) -> List[Match]:
    """The general-cost half of `_search_resident`: K7 for needles of up
    to `K7_MAX_NEEDLE` chars, K8 past it, each giving the distance AND the
    match length of every owned end position, from the device copy of the
    raw haystack.  The hits are picked on the device and only they come
    back: segment 0 starts at byte 0, so no synthetic pad needs a replay,
    and the end-0 candidate is K7's column 0, or added here for K8 (whose
    column 0 is virtual)."""
    from .ops.search_common import window_span
    from .ops.search_diag import (
        K7_MAX_NEEDLE,
        search_diag,
        suggest_own_len_diag,
    )
    from .ops.search_flat import (
        flat_search,
        prepare_flat_needle,
        suggest_own_len_flat,
    )

    m, n = len(needle), len(haystack)
    ct = _costs_tuple(costs)
    span = min(window_span(m, k, costs.gap_cost, costs.start_gap_cost), n)
    iter_len = _search_iter_len(m, n, k, costs, anchored)
    # ONE segment from the anchor: row 0 is the absolute prefix cost
    halo = 0 if anchored else span
    diag = m <= K7_MAX_NEEDLE
    if anchored:
        own_len = max(iter_len, 1)
    elif diag:
        own_len = suggest_own_len_diag(iter_len, halo)
    else:
        own_len = suggest_own_len_flat(iter_len, halo,
                                       transpose=costs.allow_transpose)
    DispatchDecision(
        path="search_diag" if diag else "flat_search",
        cost_bucket=select_cost_bucket(min(k, U32_MAX)),
        unit_k=halo,
        max_k=k,
        padded_m=m,
        padded_n=halo + own_len,
    ).log("levenshtein_search_simd_with_opts")
    hay_d = hay_d[:iter_len]
    needle_d = prepare_flat_needle(needle, device=hay_d.device)
    kk = min(k, (1 << 31) - 1)
    if diag:
        dist, length = search_diag(hay_d, needle_d, own_len=own_len,
                                   halo=halo, costs_t=ct, anchored=anchored)
        (pos_d,) = torch.nonzero(dist <= kk, as_tuple=True)
        ends = pos_d.cpu().numpy().astype(np.int64)
    else:
        dist, length = flat_search(hay_d, needle_d, own_len=own_len,
                                   halo=halo, costs_t=ct, anchored=anchored)
        dist, length = dist.reshape(-1), length.reshape(-1)
        (pos_d,) = torch.nonzero(dist <= kk, as_tuple=True)
        ends = pos_d.cpu().numpy().astype(np.int64) + 1
    dd = dist[pos_d].cpu().numpy().astype(np.int64)
    ll = length[pos_d].cpu().numpy().astype(np.int64)
    del dist, length
    d0 = m * costs.gap_cost + costs.start_gap_cost
    if not diag and d0 <= k:  # the end-0 candidate, K8's virtual column
        ends = np.concatenate(([0], ends))
        dd = np.concatenate(([d0], dd))
        ll = np.concatenate(([0], ll))
    if search_type == SearchType.Best and ends.size:
        # only global-minimum-cost candidates can survive Best's filter
        at_min = dd == dd.min()
        ends, dd, ll = ends[at_min], dd[at_min], ll[at_min]
    return _postprocess_sparse(
        list(zip(ends.tolist(), dd.tolist(), ll.tolist())), k, search_type)


def levenshtein_search_simd(needle: BytesLike, haystack: BytesLike, *,
                            device=None) -> List[Match]:
    """Default device search: k = ceil(len/2), Best, unit costs, unanchored
    (reference levenshtein.rs:1866-1878); needles of any length."""
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
    """Blessed search entry point (reference levenshtein.rs:2508-2510);
    needles of any length."""
    return levenshtein_search_simd(needle, haystack, device=device)


# ---------------------------------------------------------------------------
# Dictionary search: many needles over one resident haystack
# ---------------------------------------------------------------------------

def _canonical_device(dev: torch.device) -> torch.device:
    """`dev` with its index filled in (dropped for the CPU), so that "cuda"
    and "cuda:0" compare equal on a one-card machine."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu") if dev.type == "cpu" else dev


class PackedHaystack:
    """A haystack held on the device for repeated dictionary searches.

    The serving pattern: build once, then call `levenshtein_search_many`
    with it many times.  The constructor takes a COPY of the bytes (a
    snapshot: mutating the caller's array afterwards changes no answer),
    and `device_haystack()` uploads that copy once, at first use, onto the
    device resolved at construction (`device=None`: "cuda"); every later
    search, of any needle length and cost model, reads the same tensor.
    `uploads` counts the uploads (at most one).

    The JAX package also keeps repacked segment layouts per (G, halo,
    own_len) (`pack`); the port's kernels read the raw haystack, so there
    is nothing to repack and no `pack`.
    """

    def __init__(self, haystack: BytesLike, *, device=None):
        self.device = _canonical_device(resolve_device(device))
        self.haystack = np.array(to_bytes_array(haystack), dtype=np.uint8,
                                 copy=True)
        self._hay_dev: Optional[torch.Tensor] = None
        self.uploads = 0

    def __len__(self) -> int:
        return len(self.haystack)

    def device_haystack(self) -> torch.Tensor:
        """The raw haystack on the device (uploaded once, memoized), at a
        16-byte aligned address as the kernels read it."""
        if self._hay_dev is None:
            self._hay_dev = _upload_haystack(self.haystack, self.device)
            self.uploads += 1
        return self._hay_dev

    def pack_sharded(self, *args, **kwargs):
        """A haystack sharded across devices: not ported."""
        raise _not_ported(
            "PackedHaystack.pack_sharded",
            "parallel/sharded.py sharded_pack_segs",
        )


# Device memory one dictionary launch may hold: its int32 distances, the
# `dist <= k` mask and, for K6, the strips' boundary rows.
# benches/search_sweep.py --many, 120 needles of 24 chars at k = 3, All
# mode end to end (NVIDIA H100 80GB HBM3, 700 W), needles/s by needles a
# launch: 128 MiB 910.1 at 1, 860.4 at 2, 912.6 at 8, 927.8 at 15 (peak
# 768 -> 9,732 MB: one needle keeps the card busy); 8 MiB 2,920.7 at 1,
# 7,537.7 at 8, 9,322.1 at 30 (1,208 MB), 10,374.5 at 120 (4,810 MB);
# 1 MiB 3,072.6 at 1, 14,798.1 at 8, 23,834.2 at 30, 22,612.0 at 120.
# A launch's fixed cost only matters for small haystacks, and 1 GiB gives
# them 25 (8 MiB) to 200 (1 MiB) needles a launch.
_MANY_LAUNCH_BYTES = 1 << 30
# Elements of one launch's distances: PyTorch's CUDA `torch.nonzero` has
# refused tensors of more than 2^31 - 1 elements (15 needles at 128 MiB).
_MANY_LAUNCH_ELEMENTS = (1 << 31) - 1
# Needles of one launch: both kernels run a needle a grid row (gridDim.y).
_MANY_LAUNCH_NEEDLES = 65535


def _many_launch_plan(num: int, n: int, blocked: bool, halo: int,
                      own_len: int) -> List[Tuple[int, int]]:
    """[lo, hi) needle ranges of a dictionary group's launches: each
    launch's distances, mask and K6 scratch stay under
    `_MANY_LAUNCH_BYTES`, its distances under `_MANY_LAUNCH_ELEMENTS`
    and its needles under `_MANY_LAUNCH_NEEDLES`; at least one needle a
    launch."""
    from .ops.search_common import seg_count

    per_needle = 4 * (n + 32) + (n + 1)
    if blocked:
        per_needle += seg_count(n, own_len) * (halo + own_len + 16)
    cap = min(_MANY_LAUNCH_BYTES // per_needle,
              _MANY_LAUNCH_ELEMENTS // (n + 1), _MANY_LAUNCH_NEEDLES)
    cap = max(1, cap)
    return [(lo, min(lo + cap, num)) for lo in range(0, num, cap)]


def levenshtein_search_many(
    needles: Sequence[BytesLike],
    haystack,
    k: int,
    search_type: SearchType = SearchType.Best,
    costs: EditCosts = LEVENSHTEIN_COSTS,
    mesh=None,
    *,
    device=None,
) -> List[List[Match]]:
    """Dictionary search: every needle against one haystack, unanchored
    (the JAX package's `levenshtein_search_many`).

    The haystack is uploaded once for the whole call (and once for every
    call, when `haystack` is a `PackedHaystack`; bytes-like input builds
    a transient one).  Unit and restricted-Damerau costs: needles are
    grouped by length, and a group runs as ONE kernel launch over all its
    needles (a needle a grid row), K2 up to `ROUTE_MAX_NEEDLE` chars
    (logged `myers_search_many`) and K6 past it
    (`myers_search_many_blocked`), at the halo and owned length the single
    call picks for that needle; a group whose distances pass device
    memory's budget runs in several launches (`_many_launch_plan`), a log
    entry each.  The hits come back once a launch and split per needle
    by a sorted search; each needle then takes the single call's tail.
    Every other cost model, empty needles and an empty haystack run
    needle by needle through the single call's second part over the same
    resident haystack.

    Returns one Match list per needle, in the input order, each equal to
    `levenshtein_search_simd_with_opts(needle, haystack, k, search_type,
    costs, False)`.  A `PackedHaystack` on another device than `device`
    raises `ValueError`; `mesh=` is not ported.
    """
    from .ops.myers_chunked import blocked_search
    from .ops.myers_search import (
        collect_hits,
        myers_search,
        prepare_myers_needles,
    )

    dev = _canonical_device(resolve_device(device))
    if mesh is not None:
        raise _not_ported(
            "levenshtein_search_many(mesh=...)",
            "levenshtein.levenshtein_search_many(mesh=) over "
            "parallel/sharded.py",
        )
    needles = [to_bytes_array(nd) for nd in needles]
    if isinstance(haystack, PackedHaystack):
        packed = haystack
        if packed.device != dev:
            raise ValueError(
                f"the PackedHaystack lies on {packed.device}, the search "
                f"was asked to run on {dev}")
    else:
        packed = PackedHaystack(haystack, device=dev)
    hay = packed.haystack
    n = len(hay)
    costs.check_search()
    results: List[Optional[List[Match]]] = [None] * len(needles)
    ct = _costs_tuple(costs)
    damerau = ct == _RDAMERAU
    oracle = forced_path() == "oracle"

    by_len: dict = {}
    for i, nd in enumerate(needles):
        by_len.setdefault(len(nd), []).append(i)
    for m, idxs in sorted(by_len.items()):
        if m == 0:
            for i in idxs:
                results[i] = _empty_needle_matches(n, k, search_type, costs,
                                                   False)
            continue
        if oracle:
            for i in idxs:
                results[i] = levenshtein_search_naive_with_opts(
                    needles[i], hay, k, search_type, costs, False)
            continue
        if n == 0 or ct not in (_UNIT, _RDAMERAU):
            for i in idxs:
                results[i] = _search_resident(
                    needles[i], hay, packed.device_haystack(), k,
                    search_type, costs, False)
            continue
        engine, span, _, halo, own_len = _myers_search_plan(
            m, n, k, costs, False)
        blocked = engine == "myers_search_blocked"
        search = blocked_search if blocked else myers_search
        hay_d = packed.device_haystack()
        for lo, hi in _many_launch_plan(len(idxs), n, blocked, halo,
                                        own_len):
            part = idxs[lo:hi]
            DispatchDecision(
                path=("myers_search_many_blocked" if blocked
                      else "myers_search_many"),
                cost_bucket="u8",
                unit_k=halo,
                max_k=k,
                padded_m=m,
                padded_n=len(part),
            ).log("levenshtein_search_many")
            needles_d = prepare_myers_needles([needles[i] for i in part], m,
                                              device=dev)
            dist = search(hay_d, needles_d, own_len=own_len, halo=halo,
                          damerau=damerau)
            ni, gpos, d_arr = collect_hits(dist, min(k, (1 << 31) - 1))
            del dist
            # hits come sorted by (needle, end): one sorted search splits
            # them (a mask a needle would cost hits x needles)
            cut = np.searchsorted(ni, np.arange(len(part) + 1))
            for slot, i in enumerate(part):
                s, e = cut[slot], cut[slot + 1]
                results[i] = _hits_to_matches(
                    needles[i], hay, hay_d, gpos[s:e], d_arr[s:e], k,
                    search_type, costs, False, span)
    return results  # type: ignore[return-value]


# ---------------------------------------------------------------------------
# Names of the JAX package that the port does not carry yet
# ---------------------------------------------------------------------------

def levenshtein_search_sharded(*args, **kwargs):
    """Search over a haystack sharded across devices: not ported."""
    raise _not_ported(
        "levenshtein_search_sharded",
        "parallel/sharded.py sharded_myers_search_mins with ppermute halo "
        "exchange",
    )
