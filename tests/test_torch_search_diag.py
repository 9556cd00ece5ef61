"""Kernel K7 of the PyTorch/CUDA port (ops/search_diag.py) and its plain
version (ops/search_scan.py), and the general-cost short-needle search
route, on the CPU.

The port's `search_scan` is held against the JAX package's on the same
`chunk_haystack` segments; the plain version read from the raw haystack
(`search_diag_plain`) against the oracle over ragged segments, anchored
and not, with NUL bytes and the end-0 candidate; then
`levenshtein_search_simd_with_opts` under the general cost models of
benches/tpu_fuzz.py: the dispatch log reads `search_diag`, and the
matches equal the JAX package's public function (its `search_scan` route
on the CPU) and the oracle field for field.  Integer results, exact.
"""

import importlib

import numpy as np
import pytest
import torch

from triple_accel_tpu.ops.search_scan import (
    chunk_haystack as j_chunk_haystack,
    search_scan as j_search_scan,
)
from triple_accel_tpu.types import EditCosts as JEditCosts
from triple_accel_tpu.types import SearchType as JSearchType

from triple_accel_tpu_torch.dispatch import dispatch_history
from triple_accel_tpu_torch.ops import search_diag as sd
from triple_accel_tpu_torch.ops.search_common import window_span
from triple_accel_tpu_torch.ops.search_scan import chunk_haystack, search_scan
from triple_accel_tpu_torch.oracle import levenshtein_search_naive_with_opts
from triple_accel_tpu_torch.types import EditCosts, SearchType

# one intra-op thread: the test workers run side by side on the
# machine's cores
torch.set_num_threads(1)

jl = importlib.import_module("triple_accel_tpu.levenshtein")
tl = importlib.import_module("triple_accel_tpu_torch.levenshtein")

CPU = dict(device="cpu")
# the cost models of benches/tpu_fuzz.py:22, and a mismatch cheaper than
# a gap with a free gap start
COSTS = [(1, 1, 0, None), (1, 1, 0, 1), (2, 1, 2, None), (3, 2, 1, 2),
         (1, 2, 0, None)]
GENERAL = [(2, 1, 2, None), (3, 2, 1, 2), (1, 2, 0, None)]


def _ct(c):
    return tl._costs_tuple(EditCosts(*c))


def _as_tuples(matches):
    return [(m.start, m.end, m.k) for m in matches]


def _matches(dist, length, k, st):
    """Match list of a (dist, length) array pair over end positions 0..n,
    by the port's own sparse postprocess (Best: minimum-cost candidates)."""
    d = dist.numpy().astype(np.int64)
    ln = length.numpy().astype(np.int64)
    hits = np.flatnonzero(d <= k)
    if st == SearchType.Best and hits.size:
        hits = hits[d[hits] == d[hits].min()]
    return tl._postprocess_sparse(
        [(int(p), int(d[p]), int(ln[p])) for p in hits], k, st)


def _case(rng, m, n, alphabet=3):
    needle = rng.integers(0, alphabet, m).astype(np.uint8)
    hay = rng.integers(0, alphabet, n).astype(np.uint8)
    if n > m:
        p = int(rng.integers(0, n - m))
        hay[p: p + m] = needle
    return needle, hay


@pytest.mark.parametrize("c,anchored", [
    (COSTS[0], False), (COSTS[1], False), (COSTS[2], False),
    (COSTS[3], False), (COSTS[3], True)],
    ids=["unit", "rdamerau", "affine", "affine_transpose",
         "affine_transpose_anchored"])
def test_search_scan_equals_the_jax_search_scan(c, anchored):
    rng = np.random.default_rng(11)
    needle, hay = _case(rng, 7, 300)
    hay[:2] = 0
    needle[3] = 0
    ct = _ct(c)
    halo = 0 if anchored else window_span(7, 9, ct[1], ct[2])
    own = 400 if anchored else 64
    seg_pad, seg_n, seg_off, _, seg_len = j_chunk_haystack(hay, 7, halo,
                                                           own)
    ref_d, ref_l = j_search_scan(
        needle.astype(np.int32), seg_pad, seg_n, seg_off, needle_len=7,
        seg_len=seg_len, costs_t=ct, anchored=anchored)
    got_d, got_l = search_scan(
        torch.from_numpy(needle), torch.from_numpy(seg_pad),
        torch.from_numpy(seg_n), torch.from_numpy(seg_off),
        seg_len=seg_len, costs_t=ct, anchored=anchored)
    assert np.array_equal(got_d.numpy(), np.asarray(ref_d))
    assert np.array_equal(got_l.numpy(), np.asarray(ref_l))


def test_chunk_haystack_is_the_jax_layout():
    hay = np.random.default_rng(12).integers(0, 256, 1000).astype(np.uint8)
    for halo, own in ((0, 1000), (30, 64), (200, 333)):
        for a, b in zip(chunk_haystack(hay, 11, halo, own),
                        j_chunk_haystack(hay, 11, halo, own)):
            assert np.array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("c", COSTS[:4], ids=["unit", "rdamerau", "affine",
                                              "affine_transpose"])
def test_plain_version_equals_the_oracle(c):
    """Over ragged segments (owned lengths that split the haystack
    unevenly), anchored and not, NUL bytes, k up to past the end-0
    candidate's cost."""
    rng = np.random.default_rng(13)
    costs = EditCosts(*c)
    ct = _ct(c)
    for trial in range(8):
        m = int(rng.integers(1, 14))
        needle, hay = _case(rng, m, int(rng.integers(0, 260)))
        if trial % 3 == 0:
            needle[0] = 0
            hay[: min(2, len(hay))] = 0
        k = int(rng.integers(0, m * ct[1] + ct[2] + 2))
        anchored = trial % 4 == 3
        if anchored:
            it = min(m + max(0, k - ct[2]) // ct[1], len(hay))
            halo, own = 0, max(it, 1)
        else:
            it = len(hay)
            halo = min(window_span(m, k, ct[1], ct[2]), it)
            own = int(rng.integers(1, 50))
        dist, length = sd.search_diag(
            torch.from_numpy(hay[:it].copy()), torch.from_numpy(needle),
            own_len=own, halo=halo, costs_t=ct, anchored=anchored)
        for st in (SearchType.Best, SearchType.All):
            assert _as_tuples(_matches(dist, length, k, st)) == _as_tuples(
                levenshtein_search_naive_with_opts(needle, hay, k, st, costs,
                                                   anchored)), (trial, st)


@pytest.mark.parametrize("c,anchored", [
    (GENERAL[0], False), (GENERAL[1], False), (GENERAL[2], False),
    (GENERAL[1], True)],
    ids=["affine", "affine_transpose", "cheap_mismatch",
         "affine_transpose_anchored"])
def test_general_search_equals_jax_and_oracle(c, anchored):
    rng = np.random.default_rng(14)
    for trial in range(3):
        m = int(rng.integers(2, 20))
        needle, hay = _case(rng, m, 700 + 97 * trial)
        k = m // 2 + trial
        for st in (SearchType.Best, SearchType.All):
            dispatch_history(clear=True)
            got = tl.levenshtein_search_simd_with_opts(
                needle, hay, k, st, EditCosts(*c), anchored, **CPU)
            assert dispatch_history()[-1][1].path == "search_diag"
            ref = jl.levenshtein_search_simd_with_opts(
                needle, hay, k, JSearchType[st.name], JEditCosts(*c),
                anchored)
            exp = levenshtein_search_naive_with_opts(
                needle, hay, k, st, EditCosts(*c), anchored)
            assert _as_tuples(got) == _as_tuples(ref) == _as_tuples(exp)


def test_end0_candidate_and_nul_bytes():
    """k at the end-0 candidate's cost m*gap + start_gap: the candidate
    ending at 0 is K7's column 0 of segment 0; a NUL needle byte meets a
    NUL haystack start (segment 0 reads the raw haystack, no pad)."""
    needle = np.array([0, 65, 66], np.uint8)
    hay = np.concatenate([np.zeros(2, np.uint8),
                          np.frombuffer(b"xAB\x00AByy", np.uint8)])
    for c in GENERAL:
        costs = EditCosts(*c)
        k = 3 * costs.gap_cost + costs.start_gap_cost
        for st in (SearchType.All, SearchType.Best):
            got = tl.levenshtein_search_simd_with_opts(needle, hay, k, st,
                                                       costs, **CPU)
            exp = levenshtein_search_naive_with_opts(needle, hay, k, st,
                                                     costs)
            assert _as_tuples(got) == _as_tuples(exp)
        all_m = tl.levenshtein_search_simd_with_opts(
            needle, hay, k, SearchType.All, costs, **CPU)
        assert all_m[0].end == 0 and all_m[0].k == k


def test_wrapper_rules():
    hay = torch.zeros(10, dtype=torch.uint8)
    ct = _ct(GENERAL[0])
    with pytest.raises(ValueError, match="flat_search"):
        sd.search_diag(hay, torch.zeros(sd.K7_MAX_NEEDLE + 1,
                                        dtype=torch.uint8),
                       own_len=16, halo=0, costs_t=ct)
    with pytest.raises(ValueError, match="ONE segment"):
        sd.search_diag(hay, torch.zeros(3, dtype=torch.uint8), own_len=4,
                       halo=0, costs_t=ct, anchored=True)
    with pytest.raises(TypeError):
        sd.search_diag(hay.to(torch.int32), torch.zeros(3, dtype=torch.uint8),
                       own_len=4, halo=0, costs_t=ct)
    with pytest.raises(ValueError, match="unsupported device"):
        sd.search_diag(hay.to("meta"), torch.zeros(3, dtype=torch.uint8,
                                                   device="meta"),
                       own_len=4, halo=0, costs_t=ct)
    dist, length = sd.search_diag(hay, torch.ones(3, dtype=torch.uint8),
                                  own_len=4, halo=3, costs_t=ct)
    assert dist.shape == length.shape == (11,)
    assert int(dist[0]) == 3 * ct[1] + ct[2] and int(length[0]) == 0
    assert sd.search_diag.launches == 0  # the plain version counts none


def test_own_len_rule():
    assert sd.suggest_own_len_diag(128 << 20, 28) == 2048
    assert sd.suggest_own_len_diag(128 << 20, 600) == 40 * 256  # 16 * 632
    assert sd.suggest_own_len_diag(1000, 10) == 1024  # a short haystack
    assert sd.suggest_own_len_diag(128 << 20, 200) == 3840
    assert sd.suggest_own_len_diag(0, 0) == 256
    assert sd.K7_MAX_NEEDLE == 512


def test_a_needle_length_takes_one_engine():
    """512 chars take K7, 513 take K8, on the CPU as on the card."""
    rng = np.random.default_rng(15)
    costs = EditCosts(*GENERAL[0])
    for m, path in ((512, "search_diag"), (513, "flat_search")):
        needle = rng.integers(0, 2, m).astype(np.uint8)
        hay = np.concatenate([needle[:200], needle])
        dispatch_history(clear=True)
        got = tl.levenshtein_search_simd_with_opts(needle, hay, 4,
                                                   SearchType.All, costs,
                                                   **CPU)
        assert dispatch_history()[-1][1].path == path
        assert _as_tuples(got) == _as_tuples(
            levenshtein_search_naive_with_opts(needle, hay, 4,
                                               SearchType.All, costs))


def test_diag_plan_covers_every_row_once():
    """K7's plan for needles of 1 to 512 chars: every needle row lies in
    one slot (lane, row of the lane) of the group and no two rows in one;
    the group holds no lane the needle does not need (halving it would not
    hold the needle), no map of fewer slots exists, and of those the
    plan's leaves the fewest lanes without a row (the main path's 24 chars:
    none).  A plan= override is refused when the kernel is not built for
    it or when it would leave lanes beyond the needle."""
    for m in range(1, sd.K7_MAX_NEEDLE + 1):
        pl = sd.diag_plan(m)
        r, g = pl["rows_per_lane"], pl["lanes"]
        assert r in sd.ROW_CHOICES and g in sd.LANE_CHOICES
        slots = {(j // r, j % r) for j in range(m)}
        assert len(slots) == m and all(ln < g for ln, _ in slots)
        assert g == 4 or (g // 2) * r < m
        best = min(x * y for x in sd.LANE_CHOICES for y in sd.ROW_CHOICES
                   if x * y >= m and (x == 4 or (x // 2) * y < m))
        assert g * r == best
        idle = min(x - -(-m // y) for x in sd.LANE_CHOICES
                   for y in sd.ROW_CHOICES
                   if x * y == best and (x == 4 or (x // 2) * y < m))
        assert g - -(-m // r) == idle
    main = sd.diag_plan(24)
    assert main["lanes"] * main["rows_per_lane"] == 24
    ok = {"rows_per_lane": 1, "lanes": 32, "warps": 1}
    assert sd.diag_plan(24, ok) == ok
    for bad in ({"rows_per_lane": 5, "lanes": 8, "warps": 4},
                {"rows_per_lane": 3, "lanes": 16, "warps": 4},
                {"rows_per_lane": 1, "lanes": 16, "warps": 4},
                {"rows_per_lane": 3, "lanes": 8, "warps": 0}):
        with pytest.raises(ValueError, match="does not take"):
            sd.diag_plan(24, bad)
    with pytest.raises(ValueError, match="does not take"):
        sd.search_diag(torch.zeros(64, dtype=torch.uint8),
                       torch.ones(24, dtype=torch.uint8), own_len=64,
                       halo=0, costs_t=_ct(GENERAL[0]),
                       plan={"rows_per_lane": 16, "lanes": 32, "warps": 1})

