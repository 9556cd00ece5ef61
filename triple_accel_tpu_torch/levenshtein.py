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
  matrix's columns in registers, its warps a ring over strips of them, so
  b strings of any length), then the same walk and decode;
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

Dictionary search (`levenshtein_search_many` over a `PackedHaystack`) runs
K2 / K6 a length group a launch.  Every `mesh=` route runs the same
engines a shard per device of a `parallel.Mesh`: `levenshtein_k_batch`
a contiguous block of the batch a device, `levenshtein_search_sharded`
and `levenshtein_search_many(mesh=)` a haystack shard a device behind a
device-to-device halo ring (parallel/sharded.py), each logged with
`_sharded` appended.  Nothing falls back to the oracle, the plain
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
from .parallel.mesh import canonical_device, make_mesh, mesh_device
from .parallel.sharded import HaloWindows, collect_owned_hits, run_sharded
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
    cluster regime."""
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
      kernel's cluster regime (its warps a ring over strips of the
      columns, any length), chunked and walked the same way; traced
      batches run at their unit_k rounded up to 16;
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

    `mesh=` (a `parallel.Mesh`) splits an untraced batch into contiguous
    blocks, one a device (`parallel.batch_sharding`): the engine is chosen
    once for the whole batch, exactly as above, and each device runs it on
    its block at the batch's threshold, band and row count, with zero
    collectives; the log names it with `_sharded` appended (the JAX
    package's `myers_sharded`, `band_sharded` / `band_tiled_sharded`,
    `myers_blocked_sharded`, `flat_distance_sharded`).  A bucketed batch
    stays on the mesh bucket by bucket.  Traced batches run on the mesh's
    first device, logged `trace_mesh_ignored` as in the JAX package.
    Results never depend on the mesh.  `device=`, if given, must be the
    mesh's first device.
    """
    from .ops.band_scan import decode_walked_batch
    from .ops.lev_band import (
        MAX_TRACE_UNIT_K,
        band_plan,
        band_trace,
        prepare_band_tensors,
    )
    from .ops.trace_walk import run_bytes_per_pair, trace_walk
    from .parallel.mesh import batch_sharding
    from .parallel.sharded import run_sharded

    if mesh is None:
        dev = resolve_device(device)
    else:
        dev = mesh_device(mesh, device)

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
                    k, costs, trace_on, mesh=mesh, device=dev,
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

    def _log(path, padded_m):
        DispatchDecision(
            path=path,
            cost_bucket=select_cost_bucket(max_k),
            unit_k=uk_dev,
            max_k=max_k,
            padded_m=padded_m,
            padded_n=B,
        ).log("levenshtein_k_batch")

    if not trace_on:
        # one engine for the whole batch, then the batch on one device or
        # a contiguous block a device of the mesh
        path, padded_m, launch = _distance_engine(
            ct, max_k, max_ks, feasible, uk_dev, max_m, longest, swapped_b)
        if mesh is None:
            _log(path, padded_m)
            out = launch(swapped_a, swapped_b, dev).cpu().numpy()
        else:
            _log(path + "_sharded", padded_m)
            blocks = [(lo, hi) if hi > lo else None
                      for lo, hi in batch_sharding(mesh, B)]
            parts = run_sharded(
                mesh, lambda blk, d: launch(swapped_a[blk[0]:blk[1]],
                                            swapped_b[blk[0]:blk[1]], d,
                                            blk),
                blocks)
            out = np.concatenate([p for p in parts if p is not None])
        out = out.astype(np.int64)
        if path == "myers_blocked_distance":
            # empty-a pairs come back 0 from the kernel: D[0][n] = n gaps
            out = np.where(m_len == 0, n_len, out)
        return np.where(feasible & (out <= max_ks), out, -1)

    if mesh is not None:
        # traced batches run on the mesh's first device, as the JAX
        # package's do (its walk is host-decode dominated); the log says so
        _log("trace_mesh_ignored", max_m)
    # the band kernel streams the strings and takes its sizes at run
    # time, so rows are padded to 16, not to a power of two
    rows = -(-max(longest, 1) // 16) * 16
    plan = band_plan(rows, uk_dev, True,
                     max_n=max((len(b) for b in swapped_b), default=0))
    if plan is None:
        raise ValueError(
            f"a traced batch whose band half-width reaches {uk_dev}: "
            f"the traced band kernel takes unit_k <= {MAX_TRACE_UNIT_K}")
    _log("band_trace" if plan["regime"] in ("warp", "wide")
         else "band_trace_global", rows)
    # chunk the batch so one launch's codes and the walk's run buffer stay
    # under the cap; the chunks' runs join end to end
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


def _distance_engine(ct, max_k: int, max_ks: np.ndarray,
                     feasible: np.ndarray, uk_dev: int, max_m: int,
                     longest: int, swapped_b):
    """The untraced engine of a `levenshtein_k_batch` batch, chosen once
    for the whole batch: (dispatch path, padded rows for the log,
    launch).  `launch(a, b, device, block=None)` packs pairs (all of the
    batch's, or the rows [lo, hi) of `block`) onto `device` and returns
    their distances there, not yet fetched; every block runs at the
    batch's max_k, unit_k and max_m."""
    from .ops.lev_band import band_distance, band_plan, prepare_band_tensors
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

    if (ct == _UNIT and forced_path() != "band"
            and myers_plan(max_k) is not None):
        # the kernel takes k at run time, so the exact batch maximum
        # stands in for the JAX package's pow2-rounded static k; the
        # per-pair band still comes from the per-pair threshold
        ks = np.where(feasible, max_ks, max_k)

        def launch(a, b, dev, block=None):
            lo, hi = block or (0, len(a))
            margs = prepare_myers_inputs(a, b, max_k, max_m, ks=ks[lo:hi],
                                         device=dev)
            return myers_distance(*margs, k=max_k)

        return "myers", max_m, launch

    rows = -(-max(longest, 1) // 16) * 16
    plan = band_plan(rows, uk_dev, False,
                     max_n=max((len(b) for b in swapped_b), default=0))
    if plan is not None:
        def launch(a, b, dev, block=None):
            bargs = prepare_band_tensors(a, b, uk_dev, rows, device=dev)
            return band_distance(*bargs, unit_k=uk_dev, costs_t=ct)

        return "band", rows, launch
    if ct not in (_UNIT, _RDAMERAU) or forced_path() == "band":
        # any cost model: the row kernel, banded by the batch's unit_k
        # (exact for every pair within its threshold)
        def launch(a, b, dev, block=None):
            fargs = prepare_flat_distance_inputs(a, b, device=dev)
            return flat_distance(*fargs, costs_t=ct, unit_k=uk_dev)

        return "flat_distance", max_m, launch

    # unit and rDamerau costs: the full-matrix bit-vector distance of any
    # length (the reference's own headline call shape, levenshtein.rs:
    # 1397-1423 over its unbounded band)
    def launch(a, b, dev, block=None):
        bargs = prepare_blocked_distance_inputs(a, b, device=dev)
        return blocked_distance(*bargs, damerau=ct == _RDAMERAU)

    return "myers_blocked_distance", max_m, launch


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


def _resolve_hits_flat(needle: np.ndarray, wins, views: list,
                       gpos: np.ndarray, k: int, costs: EditCosts,
                       span: int) -> List[Tuple[int, int, int]]:
    """Length resolution of a degenerate-dense hit stream ON THE DEVICE
    (the JAX package's `_resolve_hits_flat`): the flat search kernel,
    which tracks match lengths in its DP, reruns ONLY the segments that
    hold hits, and 8 bytes a hit come back.  Work is proportional to the
    hit-bearing part of the haystack and the host replay's cost never
    applies.  Each shard of `wins` reruns the hits it owns (global end
    positions) over its own window (`views`, as `_shard_views` cut them),
    every launch issued before the first fetch.  The end-0 candidate is
    (m*gap + start_gap, 0) by definition."""
    blocks = []
    for d, view in enumerate(views):
        lo, hi = wins.bounds[d]
        mine = gpos[(gpos >= (lo if d == 0 else lo + 1)) & (gpos <= hi)]
        blocks.append(None if view is None or not mine.size
                      else (view[0], mine - lo + view[1], lo - view[1]))
    parts = run_sharded(
        wins.mesh,
        lambda blk, dev: (_flat_resolve_launch(needle, blk[0], blk[1], k,
                                               costs, span), blk[2]),
        blocks,
        fetch=lambda out: [(p + out[1], dd, ll) for p, dd, ll
                           in _flat_resolve_fetch(out[0])])
    return [c for part in parts if part is not None for c in part]


def _flat_resolve_launch(needle: np.ndarray, hay_d: torch.Tensor,
                         gpos: np.ndarray, k: int, costs: EditCosts,
                         span: int):
    """The launch half of `_resolve_hits_flat`: the flat kernel over the
    hit-bearing segments, its results left on the device."""
    from .ops.search_flat import (
        flat_search,
        prepare_flat_needle,
        suggest_own_len_flat,
    )

    gpos = np.asarray(gpos, np.int64)
    m = len(needle)
    cands: List[Tuple[int, int, int]] = []
    if gpos.size == 0:
        return cands, k, None
    iter_len = hay_d.shape[0]
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
    d0 = m * costs.gap_cost + costs.start_gap_cost
    if gpos[0] == 0 and d0 <= k:
        cands.append((0, d0, 0))
    if not pos.size:
        return cands, k, None
    needle_d = prepare_flat_needle(needle, device=hay_d.device)
    dist, length = flat_search(
        hay_d, needle_d, own_len=own_len, halo=halo,
        costs_t=_costs_tuple(costs),
        segments=torch.from_numpy(c_sel).to(hay_d.device))
    x_d = torch.from_numpy(x_of).to(hay_d.device)
    o_d = torch.from_numpy(pos - c_of * own_len - 1).to(hay_d.device)
    return cands, k, (pos, dist[x_d, o_d], length[x_d, o_d])


def _flat_resolve_fetch(launched) -> List[Tuple[int, int, int]]:
    """The fetch half of `_resolve_hits_flat`: (end, dist, length) of the
    hits the flat kernel confirms."""
    cands, k, sel = launched
    if sel is None:
        return cands
    pos, dist, length = sel
    dd = dist.cpu().numpy().astype(np.int64)
    ll = length.cpu().numpy().astype(np.int64)
    keep = dd <= k
    return cands + list(zip(pos[keep].tolist(), dd[keep].tolist(),
                            ll[keep].tolist()))


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
    as one window (`_search_windows`); `levenshtein_search_many` runs the
    same second part on a haystack uploaded once for many needles, and
    `levenshtein_search_sharded` on a window a device of a mesh.
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
    iter_len = _search_iter_len(m, n, k, costs, anchored)
    wins = HaloWindows.resident(_upload_haystack(haystack[:iter_len], dev))
    return _search_windows(needle, haystack, wins, k, search_type, costs,
                           anchored)


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


def _search_windows(needle: np.ndarray, haystack: np.ndarray, wins, k: int,
                    search_type: SearchType, costs: EditCosts,
                    anchored: bool = False) -> List[Match]:
    """The second part of every search of one needle of at least one char
    over `haystack` (on the host: the length replay reads it), whose
    windows are already on the devices (`parallel.HaloWindows`): the
    meshless call's one window, or a mesh's shard a device with a left
    halo that covers the needle's span.  The single call's engine and
    plan run on every window (K2, or K6 past `ROUTE_MAX_NEEDLE`, under
    unit and restricted-Damerau costs; K7 up to `K7_MAX_NEEDLE` chars and
    K8 past it under any other), every launch issued before the first
    fetch; each shard keeps the hits that end inside it (owner by end),
    and one tail over all shards gives the Match list.  Anchored
    searches run on the meshless call's one window."""
    from .ops.search_common import window_span

    m, n = len(needle), len(haystack)
    unit_like = _costs_tuple(costs) in (_UNIT, _RDAMERAU)
    span = min(window_span(m, k, costs.gap_cost, costs.start_gap_cost), n)
    views = _shard_views(wins, span)
    longest = max(v[0].shape[0] for v in views if v is not None)
    if unit_like:
        engine, _, _, halo, own_len = _myers_search_plan(m, longest, k,
                                                         costs, anchored)
    else:
        diag, halo, own_len = _general_plan(
            m, _search_iter_len(m, longest, k, costs, anchored), k, costs,
            anchored)
        engine = "search_diag" if diag else "flat_search"
    DispatchDecision(
        path=engine + ("_sharded" if wins.sharded else ""),
        cost_bucket=("u8" if unit_like
                     else select_cost_bucket(min(k, U32_MAX))),
        unit_k=halo,
        max_k=k,
        padded_m=m,
        padded_n=halo + own_len,
    ).log("levenshtein_search_sharded" if wins.sharded
          else "levenshtein_search_simd_with_opts")

    if not unit_like:
        # K7 or K8 a window, the lengths on the device; K8's virtual end 0
        # is shard 0's and `_general_tail` adds it once
        parts = run_sharded(
            wins.mesh,
            lambda view, dev: _general_launch(needle, view[0], k, costs,
                                              anchored),
            views, fetch=lambda out: _general_fetch(out, k))
        ends, dd, ll = collect_owned_hits(parts, _halo_eff(views),
                                          wins.bounds)
        return _general_tail(ends, dd, ll, diag, m, k, search_type, costs)
    ((gpos, d_arr),) = _myers_hits(
        [needle], m, wins, views,
        _myers_window_plans(m, views, k, costs, anchored), k, costs, anchored)
    # segment 0 starts at byte 0 with a fresh state, so there is no
    # synthetic front pad a NUL needle byte could match: kernel distances
    # <= k are exact as they are
    return _hits_to_matches(needle, haystack, wins, views, gpos, d_arr, k,
                            search_type, costs, anchored, span)


def _shard_views(wins, halo: int) -> list:
    """(window view, halo bytes it holds) of every shard that owns bytes,
    cut to at least `halo` bytes of left halo; None for an empty shard.
    Shard 0 always runs: over an empty haystack it alone owns end 0."""
    return [wins.view(d, halo) if d == 0 or wins.owned_bytes(d) else None
            for d in range(wins.mesh.size)]


def _halo_eff(views: list) -> List[int]:
    """The left halo bytes each view holds (0 for a shard that ran
    nothing)."""
    return [v[1] if v is not None else 0 for v in views]


def _myers_window_plans(m: int, views: list, k: int, costs: EditCosts,
                        anchored: bool = False) -> list:
    """(K2 or K6 wrapper, halo, own_len) for each view (None for an empty
    shard): the plan the single call picks for a haystack of the window's
    length, made once for all of a group's launches."""
    from .ops.myers_chunked import blocked_search
    from .ops.myers_search import myers_search

    plans = []
    for v in views:
        if v is None:
            plans.append(None)
            continue
        engine, _, _, halo, own_len = _myers_search_plan(
            m, v[0].shape[0], k, costs, anchored)
        plans.append((blocked_search if engine == "myers_search_blocked"
                      else myers_search, halo, own_len))
    return plans


def _myers_hits(needles: List[np.ndarray], m: int, wins, views: list,
                plans: list, k: int, costs: EditCosts,
                anchored: bool = False) -> List[Tuple[np.ndarray, np.ndarray]]:
    """(sorted end positions, distances) of each same-length needle's
    hits: one K2 or K6 launch a window (`plans`, from
    `_myers_window_plans`) for all the needles, every launch issued before
    the first fetch, the owned hits kept."""
    from .ops.myers_search import collect_hits, prepare_myers_needles

    kk = min(k, (1 << 31) - 1)
    damerau = _costs_tuple(costs) == _RDAMERAU

    def launch(block, dev):
        (hay_v, _), (search, halo, own_len) = block
        return search(hay_v, prepare_myers_needles(needles, m, device=dev),
                      own_len=own_len, halo=halo, anchored=anchored,
                      damerau=damerau)

    def fetch(dist):
        ni, gpos, d_arr = collect_hits(dist, kk)
        return gpos, ni, d_arr

    blocks = [None if v is None else (v, p) for v, p in zip(views, plans)]
    gpos, ni, d_arr = collect_owned_hits(
        run_sharded(wins.mesh, launch, blocks, fetch), _halo_eff(views),
        wins.bounds)
    if wins.mesh.size > 1:
        # shard order sorts each needle's ends; a stable sort by needle
        # brings each needle's hits together
        order = np.argsort(ni, kind="stable")
        gpos, ni, d_arr = gpos[order], ni[order], d_arr[order]
    # hits come sorted by (needle, end): one sorted search splits them (a
    # mask a needle would cost hits x needles)
    cut = np.searchsorted(ni, np.arange(len(needles) + 1))
    return [(gpos[s:e], d_arr[s:e]) for s, e in zip(cut[:-1], cut[1:])]


def _hits_to_matches(needle: np.ndarray, haystack: np.ndarray, wins,
                     views: list, gpos: np.ndarray, d_arr: np.ndarray,
                     k: int, search_type: SearchType, costs: EditCosts,
                     anchored: bool, span: int) -> List[Match]:
    """One needle's kernel hits (sorted end positions, distances <= k) to
    its Match list: Best's filter (the minimum over every shard's hits),
    the length resolution, the Best / All rules.  A dense hit stream is
    resolved over the windows `wins` / `views` it came from."""
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
        cands = _resolve_hits_flat(needle, wins, views, gpos, k, costs, span)
    else:
        cands = _resolve_hits_batch(needle, haystack, gpos, k, costs, span)
    return _postprocess_sparse(cands, k, search_type)


def _general_plan(m: int, iter_len: int, k: int, costs: EditCosts,
                  anchored: bool) -> Tuple[bool, int, int]:
    """(K7 or not, halo, own_len) of a general-cost search reading
    `iter_len` bytes."""
    from .ops.search_common import window_span
    from .ops.search_diag import K7_MAX_NEEDLE, suggest_own_len_diag
    from .ops.search_flat import suggest_own_len_flat

    span = min(window_span(m, k, costs.gap_cost, costs.start_gap_cost),
               iter_len)
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
    return diag, halo, own_len


def _general_launch(needle: np.ndarray, hay_d: torch.Tensor, k: int,
                    costs: EditCosts, anchored: bool):
    """K7 or K8 over every byte of `hay_d`: (K7 or not, distances,
    lengths), left on the device."""
    from .ops.search_diag import search_diag
    from .ops.search_flat import flat_search, prepare_flat_needle

    diag, halo, own_len = _general_plan(len(needle), hay_d.shape[0], k,
                                        costs, anchored)
    needle_d = prepare_flat_needle(needle, device=hay_d.device)
    search = search_diag if diag else flat_search
    dist, length = search(hay_d, needle_d, own_len=own_len, halo=halo,
                          costs_t=_costs_tuple(costs), anchored=anchored)
    return diag, dist, length


def _general_fetch(launched, k: int):
    """The hits of `_general_launch`'s output on the host: (end positions,
    distances, lengths) int64, ends ascending; K8's virtual end 0 is not
    among them."""
    diag, dist, length = launched
    kk = min(k, (1 << 31) - 1)
    dist, length = dist.reshape(-1), length.reshape(-1)
    (pos_d,) = torch.nonzero(dist <= kk, as_tuple=True)
    ends = pos_d.cpu().numpy().astype(np.int64) + (0 if diag else 1)
    dd = dist[pos_d].cpu().numpy().astype(np.int64)
    ll = length[pos_d].cpu().numpy().astype(np.int64)
    return ends, dd, ll


def _general_tail(ends: np.ndarray, dd: np.ndarray, ll: np.ndarray,
                  diag: bool, m: int, k: int, search_type: SearchType,
                  costs: EditCosts) -> List[Match]:
    """A general-cost search's hits to its Match list: K8's end-0
    candidate, Best's filter, the Best / All rules."""
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

class PackedHaystack:
    """A haystack held on the device for repeated dictionary searches.

    The serving pattern: build once, then call `levenshtein_search_many`
    with it many times.  The constructor takes a COPY of the bytes (a
    snapshot: mutating the caller's array afterwards changes no answer),
    and `device_haystack()` uploads that copy once, at first use, onto the
    device resolved at construction (`device=None`: "cuda"); every later
    search, of any needle length and cost model, reads the same tensor.
    `uploads` counts the uploads: one for the device copy, and D for
    each sharded pack on a mesh of D devices (`pack_sharded`).

    The JAX package also keeps repacked segment layouts per (G, halo,
    own_len) (`pack`); the port's kernels read the raw haystack, so there
    is nothing to repack and no `pack`.
    """

    def __init__(self, haystack: BytesLike, *, device=None):
        self.device = canonical_device(resolve_device(device))
        self.haystack = np.array(to_bytes_array(haystack), dtype=np.uint8,
                                 copy=True)
        self._hay_dev: Optional[torch.Tensor] = None
        self._sharded: dict = {}
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

    def pack_sharded(self, mesh, halo: int):
        """The haystack sharded on `mesh` (a `parallel.Mesh`): shard d,
        ceil(n / D) bytes, with up to `halo` bytes of its left neighbours
        before it, resident on mesh.devices[d] (`parallel.HaloWindows`:
        one upload a device, the halo by the device-to-device ring).
        Memoized per mesh: a pack serves every later call whose halo is at
        most its own (the kernels start further in), and only a larger
        halo repacks.  `uploads` grows by D a pack.

        The JAX package's pack also takes G and own_len, which shape its
        TPU segment layout; the port's kernels read the windows as they
        are, so the windows are the whole pack."""
        from .parallel.sharded import HaloWindows

        key = mesh.devices
        wins = self._sharded.get(key)
        if wins is None or wins.halo < halo:
            wins = HaloWindows(mesh, self.haystack, halo)
            self._sharded[key] = wins
            self.uploads += mesh.size
        return wins


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
    needle by needle through the single call's second part
    (`_search_windows`) over the same resident haystack.

    Returns one Match list per needle, in the input order, each equal to
    `levenshtein_search_simd_with_opts(needle, haystack, k, search_type,
    costs, False)`.  A `PackedHaystack` on another device than `device`
    raises `ValueError`.

    `mesh=` (a `parallel.Mesh`) serves the dictionary sharded: the
    `PackedHaystack`'s windows stay resident on the mesh
    (`pack_sharded`, packed once at the largest halo the call needs), a
    same-length unit or rDamerau group is one K2 (or K6) launch per device
    per memory chunk (logged `myers_search_many_sharded` /
    `myers_search_many_blocked_sharded`), the chunks planned against the
    longest shard window, and the hits are kept by the owner-by-end rule;
    the rest goes a needle at a time through the same second part on the
    same windows.  The meshless call is the one-window case of the same
    code.  Results equal the meshless call.
    The JAX signature's `G` and `own_len` shape its TPU segment layout and
    have no counterpart.  `device=`, if given, must be the mesh's first
    device, and so must the `PackedHaystack`'s.
    """
    from .ops.search_common import window_span

    if mesh is None:
        dev = canonical_device(resolve_device(device))
    else:
        dev = mesh_device(mesh, device)
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
    unit_like = _costs_tuple(costs) in (_UNIT, _RDAMERAU)
    oracle = forced_path() == "oracle"
    by_len: dict = {}
    for i, nd in enumerate(needles):
        by_len.setdefault(len(nd), []).append(i)
    spans = {m: min(window_span(m, k, costs.gap_cost, costs.start_gap_cost),
                    n) for m in by_len if m}
    wins = None
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
        if wins is None:
            # the resident haystack: one window, or a mesh's shards packed
            # at the widest span the call needs
            wins = (HaloWindows.resident(packed.device_haystack())
                    if mesh is None
                    else packed.pack_sharded(mesh, max(spans.values())))
        if n == 0 or not unit_like:
            for i in idxs:
                results[i] = _search_windows(needles[i], hay, wins, k,
                                             search_type, costs)
            continue
        span = spans[m]
        views = _shard_views(wins, span)
        # one chunk plan for every window, against the longest
        longest = max(v[0].shape[0] for v in views if v is not None)
        engine, _, _, halo, own_len = _myers_search_plan(m, longest, k,
                                                         costs, False)
        blocked = engine == "myers_search_blocked"
        plans = _myers_window_plans(m, views, k, costs)
        for lo, hi in _many_launch_plan(len(idxs), longest, blocked, halo,
                                        own_len):
            part = idxs[lo:hi]
            DispatchDecision(
                path=(("myers_search_many_blocked" if blocked
                       else "myers_search_many")
                      + ("_sharded" if wins.sharded else "")),
                cost_bucket="u8",
                unit_k=halo,
                max_k=k,
                padded_m=m,
                padded_n=len(part),
            ).log("levenshtein_search_many")
            hits = _myers_hits([needles[i] for i in part], m, wins, views,
                               plans, k, costs)
            for i, (gpos, d_arr) in zip(part, hits):
                results[i] = _hits_to_matches(
                    needles[i], hay, wins, views, gpos, d_arr, k,
                    search_type, costs, False, span)
    return results  # type: ignore[return-value]


# ---------------------------------------------------------------------------
# Search over a haystack sharded across a mesh
# ---------------------------------------------------------------------------

def levenshtein_search_sharded(
    needle: BytesLike,
    haystack: BytesLike,
    k: int,
    mesh=None,
    search_type: SearchType = SearchType.Best,
    costs: EditCosts = LEVENSHTEIN_COSTS,
    *,
    device=None,
) -> List[Match]:
    """Unanchored search of ONE haystack sharded across a mesh (the JAX
    package's `levenshtein_search_sharded`, the SP/ring strategy): the
    result is exactly `levenshtein_search_simd_with_opts(needle, haystack,
    k, search_type, costs, False)`'s, only the placement differs.
    `mesh=None` takes every visible card (`parallel.make_mesh()`).

    The haystack splits into D shards of ceil(n / D) bytes; device d gets
    [left halo | shard d] (`parallel.HaloWindows`: one upload a shard,
    the halo, the needle's widest match window, copied device to device
    from as many left neighbours as it spans) and runs the single call's
    engine and plan on its window (`_search_windows`, whose one-window
    case is the single call): K2, or K6 past `ROUTE_MAX_NEEDLE`,
    under unit and rDamerau costs (logged `myers_search_sharded`,
    `myers_search_rdamerau_sharded`, `myers_search_blocked_sharded`), K7
    up to 512 chars and K8 past that under any other cost model
    (`search_diag_sharded`, `flat_search_sharded`).  The JAX package sends
    every general-cost needle to its flat kernel on a mesh; every engine
    is exact, so the port keeps the single call's choice.  A shard keeps
    the hits that end inside it (owner by end), Best's minimum is taken
    over all shards, and the length replay reads the host haystack; a
    dense hit stream gets its lengths from K8 a shard over that shard's
    window.

    Anchored search is not offered, as in the JAX package: only shard 0
    could hold an anchored match.  `device=`, if given, must be the
    mesh's first device.
    """
    from .ops.search_common import window_span

    if mesh is None:
        mesh = make_mesh()
    mesh_device(mesh, device)
    needle = to_bytes_array(needle)
    haystack = to_bytes_array(haystack)
    m, n = len(needle), len(haystack)
    if m == 0:
        return _empty_needle_matches(n, k, search_type, costs, False)
    costs.check_search()
    if forced_path() == "oracle":
        return levenshtein_search_naive_with_opts(
            needle, haystack, k, search_type, costs, False)
    span = min(window_span(m, k, costs.gap_cost, costs.start_gap_cost), n)
    wins = HaloWindows(mesh, haystack, span)
    return _search_windows(needle, haystack, wins, k, search_type, costs)
