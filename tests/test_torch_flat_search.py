"""Kernel K8 of the PyTorch/CUDA port (ops/search_flat.py, search mode),
the general-cost long-needle search route and the dense-hit length
resolution, on the CPU.

K8's plain version, `flat_search_plain` (the row recurrence with the
exclusive (min cost, max length) prefix combine, one row a segment), is
held against the oracle under five cost models, over all segments and
over a selection, anchored and not.  Then the public routes: a needle
past K7's 512 chars under general costs (dispatch `flat_search`) against
the JAX package's public function (its `search_scan` route on the CPU) and
the oracle; and a unit / rDamerau hit stream past the host replay budget
(patched down here so that the case stays small), whose lengths come from
K8 over the hit-bearing segments (dispatch `flat_resolve`).  Integer
results, exact.
"""

import importlib

import numpy as np
import pytest
import torch

from triple_accel_tpu.types import EditCosts as JEditCosts
from triple_accel_tpu.types import SearchType as JSearchType

from triple_accel_tpu_torch.dispatch import dispatch_history
from triple_accel_tpu_torch.ops import search_flat as sf
from triple_accel_tpu_torch.ops.band_scan import INF
from triple_accel_tpu_torch.ops.search_common import seg_count, window_span
from triple_accel_tpu_torch.oracle import levenshtein_search_naive_with_opts
from triple_accel_tpu_torch.types import (
    EditCosts,
    LEVENSHTEIN_COSTS,
    RDAMERAU_COSTS,
    SearchType,
)

# one intra-op thread: the test workers run side by side on the
# machine's cores
torch.set_num_threads(1)

jl = importlib.import_module("triple_accel_tpu.levenshtein")
tl = importlib.import_module("triple_accel_tpu_torch.levenshtein")

CPU = dict(device="cpu")
COSTS = [(1, 1, 0, None), (1, 1, 0, 1), (2, 1, 2, None), (3, 2, 1, 2),
         (1, 2, 0, None)]
IDS = ["unit", "rdamerau", "affine", "affine_transpose", "cheap_mismatch"]


def _ct(c):
    return tl._costs_tuple(EditCosts(*c))


def _as_tuples(matches):
    return [(m.start, m.end, m.k) for m in matches]


def _matches(dist, length, m, ct, k, st):
    """Match list of K8's [S, own_len] output over all segments, with the
    end-0 candidate (m*gap + start_gap, length 0) added as the route adds
    it."""
    d = dist.reshape(-1).numpy().astype(np.int64)
    ln = length.reshape(-1).numpy().astype(np.int64)
    hits = np.flatnonzero(d <= k)
    cands = [(int(p) + 1, int(d[p]), int(ln[p])) for p in hits]
    d0 = m * ct[1] + ct[2]
    if d0 <= k:
        cands.insert(0, (0, d0, 0))
    if st == SearchType.Best and cands:
        kmin = min(x[1] for x in cands)
        cands = [x for x in cands if x[1] == kmin]
    return tl._postprocess_sparse(cands, k, st)


def _case(rng, m, n, alphabet=3):
    needle = rng.integers(0, alphabet, m).astype(np.uint8)
    hay = rng.integers(0, alphabet, n).astype(np.uint8)
    if n > m:
        p = int(rng.integers(0, n - m))
        hay[p: p + m] = needle
    return needle, hay


@pytest.mark.parametrize("c", COSTS, ids=IDS)
def test_plain_version_equals_the_oracle(c):
    """Unanchored over ragged segments and anchored as one segment; NUL
    bytes; k up to past the end-0 candidate's cost."""
    rng = np.random.default_rng(21)
    costs = EditCosts(*c)
    ct = _ct(c)
    for trial in range(8):
        m = int(rng.integers(1, 16))
        needle, hay = _case(rng, m, int(rng.integers(0, 240)))
        if trial % 3 == 0:
            needle[-1] = 0
            hay[: min(3, len(hay))] = 0
        k = int(rng.integers(0, m * ct[1] + ct[2] + 2))
        anchored = trial % 4 == 3
        if anchored:
            it = min(m + max(0, k - ct[2]) // ct[1], len(hay))
            halo, own = 0, max(it, 1)
        else:
            it = len(hay)
            halo = min(window_span(m, k, ct[1], ct[2]), it)
            own = int(rng.integers(1, 60))
        dist, length = sf.flat_search(
            torch.from_numpy(hay[:it].copy()), torch.from_numpy(needle),
            own_len=own, halo=halo, costs_t=ct, anchored=anchored)
        for st in (SearchType.Best, SearchType.All):
            assert _as_tuples(_matches(dist, length, m, ct, k, st)) == (
                _as_tuples(levenshtein_search_naive_with_opts(
                    needle, hay, k, st, costs, anchored))), (trial, st)


def test_selected_segments_equal_their_rows_of_the_full_run():
    rng = np.random.default_rng(22)
    needle, hay = _case(rng, 9, 700)
    ct = _ct(COSTS[3])
    kw = dict(own_len=50, halo=window_span(9, 8, ct[1], ct[2]), costs_t=ct)
    h, nd = torch.from_numpy(hay), torch.from_numpy(needle)
    full_d, full_l = sf.flat_search(h, nd, **kw)
    sel = np.array([0, 3, 4, 13], np.int64)
    d, ln = sf.flat_search(h, nd, segments=torch.from_numpy(sel), **kw)
    assert full_d.shape == (seg_count(700, 50), 50)
    assert torch.equal(d, full_d[sel]) and torch.equal(ln, full_l[sel])
    assert int(d[-1, -1]) < INF  # the last segment ends at the haystack's
    with pytest.raises(ValueError, match="outside"):
        sf.flat_search(h, nd, segments=torch.tensor([14]), **kw)


@pytest.mark.parametrize("c,anchored", [
    (COSTS[2], False), (COSTS[3], False), (COSTS[3], True)],
    ids=["affine", "affine_transpose", "affine_transpose_anchored"])
def test_long_needle_general_search_equals_jax_and_oracle(c, anchored):
    """Needles past K7's 512 chars: the dispatch log reads `flat_search`,
    the matches equal the JAX package's public function (its scan route)
    and the oracle."""
    rng = np.random.default_rng(23)
    m = 530
    needle = rng.integers(0, 4, m).astype(np.uint8)
    copy = needle.copy()
    copy[[50, 300]] = (copy[[50, 300]] + 1) % 4
    copy[100], copy[101] = copy[101], copy[100]
    hay = np.concatenate([copy if anchored else copy[:40],
                          rng.integers(0, 4, 100).astype(np.uint8), copy])
    k = 12
    for st in (SearchType.Best, SearchType.All):
        dispatch_history(clear=True)
        got = tl.levenshtein_search_simd_with_opts(
            needle, hay, k, st, EditCosts(*c), anchored, **CPU)
        assert dispatch_history()[-1][1].path == "flat_search"
        ref = jl.levenshtein_search_simd_with_opts(
            needle, hay, k, JSearchType[st.name], JEditCosts(*c), anchored)
        exp = levenshtein_search_naive_with_opts(needle, hay, k, st,
                                                 EditCosts(*c), anchored)
        assert got and _as_tuples(got) == _as_tuples(ref) == _as_tuples(exp)


@pytest.mark.parametrize("costs", [LEVENSHTEIN_COSTS, RDAMERAU_COSTS],
                         ids=["unit", "rdamerau"])
def test_dense_hit_stream_resolves_on_the_flat_kernel(costs, monkeypatch):
    """A periodic needle over a periodic haystack: every end position is a
    hit; past the (patched) replay budget the lengths come from K8 over the
    hit-bearing segments, and the end-0 candidate by definition."""
    monkeypatch.setattr(tl, "_RESOLVE_CELLS_BUDGET", 40_000)
    needle = np.frombuffer(b"ab" * 20, np.uint8)
    hay = np.frombuffer(b"ab" * 1000, np.uint8)
    k = 38
    for st in (SearchType.All, SearchType.Best):
        dispatch_history(clear=True)
        got = tl.levenshtein_search_simd_with_opts(needle, hay, k, st, costs,
                                                   **CPU)
        assert [d.path for _, d in dispatch_history()][-1] == "flat_resolve"
        ref = jl.levenshtein_search_simd_with_opts(
            needle, hay, k, JSearchType[st.name],
            JEditCosts(*(1, 1, 0, 1 if costs.allow_transpose else None)))
        exp = levenshtein_search_naive_with_opts(needle, hay, k, st, costs)
        assert _as_tuples(got) == _as_tuples(ref) == _as_tuples(exp)
    all_m = tl.levenshtein_search_simd_with_opts(needle, hay, 40,
                                                 SearchType.All, costs, **CPU)
    assert all_m[0].end == 0 and all_m[0].k == 40  # the end-0 candidate


def test_end0_candidate_is_added_by_the_route():
    """K8's column 0 is virtual: the route adds D[m][0] = m*gap +
    start_gap with length 0 when it is within k, and only then."""
    rng = np.random.default_rng(24)
    needle = rng.integers(0, 3, 600).astype(np.uint8)
    hay = rng.integers(0, 3, 50).astype(np.uint8)
    costs = EditCosts(2, 1, 2, None)
    for k in (601, 602):  # the end-0 candidate costs 602
        got = tl.levenshtein_search_simd_with_opts(needle, hay, k,
                                                   SearchType.All, costs,
                                                   **CPU)
        assert (_as_tuples(got)[:1] == [(0, 0, 602)]) == (k == 602)
        assert _as_tuples(got) == _as_tuples(
            levenshtein_search_naive_with_opts(needle, hay, k,
                                               SearchType.All, costs))


def test_wrapper_rules_and_plans():
    h = torch.zeros(100, dtype=torch.uint8)
    nd = torch.ones(3, dtype=torch.uint8)
    ct = _ct(COSTS[2])
    with pytest.raises(ValueError, match="ONE segment"):
        sf.flat_search(h, nd, own_len=50, halo=0, costs_t=ct, anchored=True)
    with pytest.raises(TypeError):
        sf.flat_search(h.to(torch.int32), nd, own_len=50, halo=0,
                       costs_t=ct)
    with pytest.raises(ValueError, match="unsupported device"):
        sf.flat_search(h.to("meta"), nd.to("meta"), own_len=50, halo=0,
                       costs_t=ct)
    with pytest.raises(ValueError, match="2..30 columns"):
        sf.flat_search(h, nd, own_len=sf.MAX_ITEM_LEN, halo=3, costs_t=ct)
    d, ln = sf.flat_search(h, nd, own_len=64, halo=3, costs_t=ct)
    assert d.shape == ln.shape == (2, 64)
    assert bool((d[1, 36:] == INF).all())  # past the haystack
    assert sf.flat_search.launches == 0  # the plain version counts none
    for transpose in (False, True):  # each kernel variant's own shape
        threads, cols, per_sm = sf.SEARCH_SHAPES[transpose]
        rj = threads * cols
        assert threads <= sf.max_threads(True, cols)
        own = sf.suggest_own_len_flat(16 << 20, 3148, transpose=transpose)
        assert own % rj == 0 and own >= 8 * 3148
        # one wave: at most the variant's blocks an SM on each of 132 SMs
        assert -(-(16 << 20) // own) <= per_sm * 132
        assert sf.suggest_own_len_flat(1000, 10, transpose=transpose) == rj
    assert torch.equal(sf.prepare_flat_needle(b"ab\x00", device="cpu"),
                       torch.tensor([97, 98, 0], dtype=torch.uint8))


def test_prefix_combine_keeps_the_longest_on_ties():
    g = torch.tensor([[5, 3, 3, 7, 3, 1]], dtype=torch.int64)
    a = torch.tensor([[0, 2, 9, 1, 4, 0]], dtype=torch.int64)
    pg, pa = sf._scan_min_long(g, a)
    assert pg.tolist() == [[5, 3, 3, 3, 3, 1]]
    assert pa.tolist() == [[0, 2, 9, 9, 9, 0]]
