"""Scalar (NumPy/Python) oracle for Levenshtein distance, traceback and search.

Conformance oracle for the device paths of the PyTorch/CUDA port.  It reproduces — cell for cell,
tie-break for tie-break — the reference's scalar implementations:

* `levenshtein_naive_with_opts`   (reference src/levenshtein.rs:148-319)
* `levenshtein_naive_k_with_opts` (reference src/levenshtein.rs:376-607)
* `levenshtein_search_naive_with_opts` (reference src/levenshtein.rs:1589-1838)

The tie-break contract (SURVEY.md §2.3) is load-bearing and differs between
the full and banded variants:

* full DP: on cost ties, substitution wins over both gaps, a-gap wins over
  b-gap, transpose wins over everything.
* banded DP: same effective priority (sub default; gaps only on strict
  improvement; transpose on <=).
* search: secondary objective is to MAXIMIZE match length on cost ties,
  with the exact (slightly quirky) comparison order of the reference.

These loops are deliberately literal, not vectorized: the oracle's job is to
be obviously correct so the device kernels can be judged against it.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from ..types import (
    BytesLike,
    Edit,
    EditCosts,
    EditType,
    LEVENSHTEIN_COSTS,
    Match,
    SearchType,
    to_bytes_array,
    to_symbol_array,
)

__all__ = [
    "levenshtein_naive",
    "levenshtein_naive_with_opts",
    "levenshtein_naive_k",
    "levenshtein_naive_k_with_opts",
    "levenshtein_search_naive",
    "levenshtein_search_naive_with_opts",
    "compute_max_k",
    "compute_unit_k",
    "default_search_k",
]

INF = (1 << 32) - 1  # u32::MAX stand-in; adds are saturated against it


def _sat_add(x: int, y: int) -> int:
    s = x + y
    return INF if s > INF else s


def compute_max_k(a_len: int, b_len: int, k: int, costs: EditCosts) -> int:
    """Tight upper bound on the edit cost, used to cap `k`.

    Mirrors the max_k computation of the reference dispatcher
    (levenshtein.rs:399-423 / 731-757): the distance can never exceed
    "mismatch everything" or "gap everything out and back in" plus the cost
    of gapping the length difference.
    """
    min_len = min(a_len, b_len)
    max_len = max(a_len, b_len)
    mc, gc, sgc = costs.mismatch_cost, costs.gap_cost, costs.start_gap_cost
    max_k = min(
        min_len * mc,
        (min_len << 1) * gc
        + (0 if min_len == 0 else sgc + (sgc if max_len == min_len else 0)),
    )
    max_k = min(
        k,
        max_k + (max_len - min_len) * gc + (0 if max_len == min_len else sgc),
    )
    return max_k


def compute_unit_k(max_k: int, costs: EditCosts) -> int:
    """Band half-width: how far the DP may stray from the main diagonal.

    Mirrors reference levenshtein.rs:426 / 760-763: at least one gap must be
    started, then each unit of deviation costs one gap extension.
    """
    return max(0, max_k - costs.start_gap_cost) // costs.gap_cost


def default_search_k(needle_len: int) -> int:
    """Default k for levenshtein searches: ceil(needle_len / 2).

    Mirrors reference levenshtein.rs:1556, 1873.
    """
    return (needle_len >> 1) + (needle_len & 1)


def _rle_push(res: List[Edit], e: EditType) -> None:
    if res and res[-1].edit == e:
        res[-1] = Edit(edit=e, count=res[-1].count + 1)
    else:
        res.append(Edit(edit=e, count=1))


def levenshtein_naive_with_opts(
    a: BytesLike,
    b: BytesLike,
    trace_on: bool = False,
    costs: EditCosts = LEVENSHTEIN_COSTS,
) -> Tuple[int, Optional[List[Edit]]]:
    """Full O(nm) DP with optional traceback (reference levenshtein.rs:148-319).

    Rows iterate over the longer string `b_new`, columns over the shorter
    `a_new` (inputs are swapped so len(a_new) <= len(b_new); the traceback
    flips AGap/BGap back when swapped).  Traceback codes per cell:
    0 = substitution/match, 1 = consume b (AGap), 2 = consume a (BGap),
    3 = transpose; tie priority: transpose(<=) > sub(<=) > a-gap > b-gap.

    Generic over the symbol alphabet like the reference (`T: PartialEq`,
    levenshtein.rs:148): accepts any integer symbols (or str), not just
    bytes — the DP only compares symbols for equality.
    """
    a = to_symbol_array(a)
    b = to_symbol_array(b)
    swap = len(a) > len(b)
    a_new, b_new = (b, a) if swap else (a, b)
    a_len, b_len = len(a_new), len(b_new)
    mc, gc, sgc = costs.mismatch_cost, costs.gap_cost, costs.start_gap_cost
    tc = costs.transpose_cost_or_zero
    allow_transpose = costs.allow_transpose

    length = a_len + 1
    dp0 = [0] * length
    dp1 = [0] * length
    dp2 = [0] * length
    a_gap_dp = [INF] * length
    b_gap_dp = [INF] * length
    traceback = [[0] * length for _ in range(b_len + 1)] if trace_on else None

    for i in range(length):
        dp1[i] = i * gc + (0 if i == 0 else sgc)
        if trace_on:
            traceback[0][i] = 2

    for i in range(1, b_len + 1):
        a_gap_dp[0] = i * gc + sgc
        dp2[0] = i * gc + sgc
        if trace_on:
            traceback[i][0] = 1

        for j in range(1, length):
            sub = dp1[j - 1] + (mc if a_new[j - 1] != b_new[i - 1] else 0)
            a_gap_dp[j] = min(dp1[j] + sgc + gc, _sat_add(a_gap_dp[j], gc))
            b_gap_dp[j] = min(dp2[j - 1] + sgc + gc, _sat_add(b_gap_dp[j - 1], gc))

            dp2[j] = a_gap_dp[j]
            code = 1
            if b_gap_dp[j] < dp2[j]:
                dp2[j] = b_gap_dp[j]
                code = 2
            if sub <= dp2[j]:
                dp2[j] = sub
                code = 0
            if (
                allow_transpose
                and i > 1
                and j > 1
                and a_new[j - 1] == b_new[i - 2]
                and a_new[j - 2] == b_new[i - 1]
            ):
                transpose = dp0[j - 2] + tc
                if transpose <= dp2[j]:
                    dp2[j] = transpose
                    code = 3
            if trace_on:
                traceback[i][j] = code

        dp0, dp1, dp2 = dp1, dp2, dp0

    dist = dp1[a_len]
    if not trace_on:
        return dist, None

    res: List[Edit] = []
    i, j = b_len, a_len
    while i > 0 or j > 0:
        code = traceback[i][j]
        if code == 0:
            i -= 1
            j -= 1
            e = EditType.Match if a_new[j] == b_new[i] else EditType.Mismatch
        elif code == 1:
            i -= 1
            e = EditType.BGap if swap else EditType.AGap
        elif code == 2:
            j -= 1
            e = EditType.AGap if swap else EditType.BGap
        else:
            i -= 2
            j -= 2
            e = EditType.Transpose
        _rle_push(res, e)

    res.reverse()
    return dist, res


def levenshtein_naive(a: BytesLike, b: BytesLike) -> int:
    """Unit-cost Levenshtein distance (reference levenshtein.rs:105-107).

    >>> levenshtein_naive(b"abc", b"ab")
    1
    """
    return levenshtein_naive_with_opts(a, b, False, LEVENSHTEIN_COSTS)[0]


def levenshtein_naive_k_with_opts(
    a: BytesLike,
    b: BytesLike,
    k: int,
    trace_on: bool = False,
    costs: EditCosts = LEVENSHTEIN_COSTS,
) -> Optional[Tuple[int, Optional[List[Edit]]]]:
    """Banded DP bounded by cost `k` (reference levenshtein.rs:376-607).

    Rows iterate over the SHORTER string `a_new`, the band covers positions
    of the longer `b_new` with |j - i| <= unit_k.  Returns None when the
    distance exceeds the capped threshold max_k.  Traceback codes:
    0 = sub, 1 = consume b (AGap), 2 = consume a (BGap), 3 = transpose; tie
    priority: transpose(<=) > sub > a-gap > b-gap.

    Accepts any integer symbol alphabet (see `to_symbol_array`).
    """
    a = to_symbol_array(a)
    b = to_symbol_array(b)
    swap = len(a) > len(b)
    a_new, b_new = (b, a) if swap else (a, b)
    a_len, b_len = len(a_new), len(b_new)
    mc, gc, sgc = costs.mismatch_cost, costs.gap_cost, costs.start_gap_cost
    tc = costs.transpose_cost_or_zero
    allow_transpose = costs.allow_transpose

    max_k = compute_max_k(a_len, b_len, k, costs)
    unit_k = compute_unit_k(max_k, costs)

    if b_len - a_len > unit_k:
        return None

    length = a_len + 1
    lo = 0
    hi = min(unit_k + 1, b_len + 1)
    prev_lo1 = 0
    k_len = min((unit_k << 1) + 1, b_len + 1)
    dp0 = [0] * k_len
    dp1 = [0] * k_len
    dp2 = [0] * k_len
    a_gap_dp = [INF] * k_len
    b_gap_dp = [INF] * k_len
    traceback = [[0] * k_len for _ in range(length)] if trace_on else None

    for i in range(hi - lo):
        dp1[i] = i * gc + (0 if i == 0 else sgc)
        if trace_on:
            traceback[0][i] = 1

    for i in range(1, length):
        prev_lo0 = prev_lo1
        prev_lo1 = lo
        prev_hi = hi
        hi = min(hi + 1, b_len + 1)
        if i > unit_k:
            lo += 1

        for j in range(hi - lo):
            idx = lo + j
            if idx == 0:
                sub = INF
            else:
                sub = dp1[idx - 1 - prev_lo1] + (
                    mc if a_new[i - 1] != b_new[idx - 1] else 0
                )
            if j == 0:
                a_gap_dp[j] = INF
            else:
                a_gap_dp[j] = min(
                    dp2[j - 1] + sgc + gc, _sat_add(a_gap_dp[j - 1], gc)
                )
            if idx >= prev_hi:
                b_gap_dp[j] = INF
            else:
                b_gap_dp[j] = min(
                    dp1[idx - prev_lo1] + sgc + gc,
                    _sat_add(b_gap_dp[idx - prev_lo1], gc),
                )

            dp2[j] = sub
            code = 0
            if a_gap_dp[j] < dp2[j]:
                dp2[j] = a_gap_dp[j]
                code = 1
            if b_gap_dp[j] < dp2[j]:
                dp2[j] = b_gap_dp[j]
                code = 2
            if (
                allow_transpose
                and i > 1
                and idx > 1
                and a_new[i - 1] == b_new[idx - 2]
                and a_new[i - 2] == b_new[idx - 1]
            ):
                transpose = dp0[idx - prev_lo0 - 2] + tc
                if transpose <= dp2[j]:
                    dp2[j] = transpose
                    code = 3
            if trace_on:
                traceback[i][j] = code

        dp0, dp1, dp2 = dp1, dp2, dp0

    dist = dp1[hi - lo - 1]
    if dist > max_k:
        return None
    if not trace_on:
        return dist, None

    res: List[Edit] = []
    i, j = a_len, b_len
    while i > 0 or j > 0:
        code = traceback[i][j - (i - unit_k if i > unit_k else 0)]
        if code == 0:
            i -= 1
            j -= 1
            e = EditType.Match if a_new[i] == b_new[j] else EditType.Mismatch
        elif code == 1:
            j -= 1
            e = EditType.BGap if swap else EditType.AGap
        elif code == 2:
            i -= 1
            e = EditType.AGap if swap else EditType.BGap
        else:
            i -= 2
            j -= 2
            e = EditType.Transpose
        _rle_push(res, e)

    res.reverse()
    return dist, res


def levenshtein_naive_k(a: BytesLike, b: BytesLike, k: int) -> Optional[int]:
    """Banded unit-cost distance (reference levenshtein.rs:342-349)."""
    res = levenshtein_naive_k_with_opts(a, b, k, False, LEVENSHTEIN_COSTS)
    return None if res is None else res[0]


def levenshtein_search_naive_with_opts(
    needle: BytesLike,
    haystack: BytesLike,
    k: int,
    search_type: SearchType = SearchType.Best,
    costs: EditCosts = LEVENSHTEIN_COSTS,
    anchored: bool = False,
) -> List[Match]:
    """Approximate string search (reference levenshtein.rs:1589-1838).

    Column-wise DP over haystack positions with match-length tracking.
    Row 0 is free for unanchored searches (a match may start anywhere);
    anchored searches charge `i*gap + start_gap` for skipping i haystack
    characters and are capped at needle_len + (k - start_gap) / gap columns.
    Tie contract on equal costs: maximize match length, with the reference's
    exact comparison order (levenshtein.rs:1723-1779).  Best mode: curr_k
    shrinks as matches stream, a later match replaces the previous one if it
    fully overlaps it (start <= previous start), and the final list keeps
    only k == final curr_k (levenshtein.rs:1812-1835).
    """
    needle = to_bytes_array(needle)
    haystack = to_bytes_array(haystack)
    needle_len = len(needle)
    haystack_len = len(haystack)
    mc, gc, sgc = costs.mismatch_cost, costs.gap_cost, costs.start_gap_cost
    tc = costs.transpose_cost_or_zero
    allow_transpose = costs.allow_transpose

    if needle_len == 0:
        # special cases (reference levenshtein.rs:1600-1644)
        if not anchored:
            return []
        if search_type == SearchType.Best:
            return [Match(start=0, end=0, k=0)]
        res = [Match(start=0, end=0, k=0)]
        cost = sgc
        for i in range(1, haystack_len + 1):
            cost += gc
            if cost <= k:
                res.append(Match(start=0, end=i, k=cost))
            else:
                break
        return res

    costs.check_search()

    length = needle_len + 1
    if anchored:
        iter_len = min(needle_len + max(0, k - sgc) // gc, haystack_len)
    else:
        iter_len = haystack_len

    dp0 = [0] * length
    dp1 = [0] * length
    dp2 = [0] * length
    needle_gap_dp = [INF] * length
    haystack_gap_dp = [INF] * length
    length0 = [0] * length
    length1 = [0] * length
    length2 = [0] * length
    needle_gap_length = [0] * length
    haystack_gap_length = [0] * length

    curr_k = k
    candidates: List[Match] = []  # streamed (match, curr_k-at-emission)

    for j in range(length):
        dp1[j] = j * gc + (0 if j == 0 else sgc)

    if dp1[length - 1] <= curr_k:
        if search_type == SearchType.Best:
            curr_k = dp1[length - 1]
        candidates.append(Match(start=0, end=0, k=dp1[length - 1]))

    for i in range(iter_len):
        boundary = (i + 1) * gc + sgc if anchored else 0
        needle_gap_dp[0] = boundary
        dp2[0] = boundary
        needle_gap_length[0] = 0
        length2[0] = 0

        for j in range(1, length):
            sub = dp1[j - 1] + (mc if needle[j - 1] != haystack[i] else 0)

            new_gap = dp1[j] + sgc + gc
            cont_gap = _sat_add(needle_gap_dp[j], gc)
            if new_gap < cont_gap:
                needle_gap_dp[j] = new_gap
                needle_gap_length[j] = length1[j] + 1
            elif new_gap > cont_gap:
                needle_gap_dp[j] = cont_gap
                needle_gap_length[j] += 1
            else:
                needle_gap_dp[j] = cont_gap
                needle_gap_length[j] = max(length1[j], needle_gap_length[j]) + 1

            new_gap = dp2[j - 1] + sgc + gc
            cont_gap = _sat_add(haystack_gap_dp[j - 1], gc)
            if new_gap < cont_gap:
                haystack_gap_dp[j] = new_gap
                haystack_gap_length[j] = length2[j - 1]
            elif new_gap > cont_gap:
                haystack_gap_dp[j] = cont_gap
                haystack_gap_length[j] = haystack_gap_length[j - 1]
            else:
                haystack_gap_dp[j] = cont_gap
                haystack_gap_length[j] = max(
                    length2[j - 1], haystack_gap_length[j - 1]
                )

            dp2[j] = needle_gap_dp[j]
            length2[j] = needle_gap_length[j]

            if haystack_gap_dp[j] < dp2[j] or (
                haystack_gap_dp[j] == dp2[j] and length2[j - 1] > length2[j]
            ):
                dp2[j] = haystack_gap_dp[j]
                length2[j] = haystack_gap_length[j]

            if sub < dp2[j] or (sub == dp2[j] and (length1[j - 1] + 1) > length2[j]):
                dp2[j] = sub
                length2[j] = length1[j - 1] + 1

            if (
                allow_transpose
                and i > 0
                and j > 1
                and needle[j - 1] == haystack[i - 1]
                and needle[j - 2] == haystack[i]
            ):
                transpose = dp0[j - 2] + tc
                if transpose <= dp2[j]:
                    dp2[j] = transpose
                    length2[j] = length0[j - 2] + 2

        final_res = dp2[length - 1]
        final_length = length2[length - 1]

        dp0, dp1, dp2 = dp1, dp2, dp0
        length0, length1, length2 = length1, length2, length0

        if final_res <= curr_k:
            if search_type == SearchType.Best:
                curr_k = final_res
            candidates.append(
                Match(start=i + 1 - final_length, end=i + 1, k=final_res)
            )

    if search_type == SearchType.Best:
        res_vec: List[Match] = []
        for m in candidates:
            if res_vec and m.start <= res_vec[-1].start:
                res_vec[-1] = m  # replace previous if fully overlapping
            else:
                res_vec.append(m)
        return [m for m in res_vec if m.k == curr_k]

    return candidates


def levenshtein_search_naive(needle: BytesLike, haystack: BytesLike) -> List[Match]:
    """Default search: k = ceil(len/2), Best, unit costs, unanchored
    (reference levenshtein.rs:1549-1561)."""
    needle = to_bytes_array(needle)
    return levenshtein_search_naive_with_opts(
        needle,
        haystack,
        default_search_k(len(needle)),
        SearchType.Best,
        LEVENSHTEIN_COSTS,
        False,
    )
