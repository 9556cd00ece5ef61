"""The plain references against the port's scalar oracle at small sizes
(the test may import both; the references import nothing of the port)."""

import numpy as np
import pytest
import torch

from portbench.reference.distance import gap_affine_distances
from portbench.reference.search import filter_pieces, search_matches
from portbench.traffic import ACGT, edit_acgt, random_acgt
from triple_accel_tpu_torch.oracle.levenshtein import (
    levenshtein_naive_with_opts,
    levenshtein_search_naive_with_opts,
)
from triple_accel_tpu_torch.types import EditCosts, SearchType

torch.set_num_threads(1)

COSTS = [
    {"mismatch_cost": 4, "gap_cost": 2, "start_gap_cost": 6},
    {"mismatch_cost": 1, "gap_cost": 1, "start_gap_cost": 0},
    {"mismatch_cost": 2, "gap_cost": 1, "start_gap_cost": 3},
    {"mismatch_cost": 5, "gap_cost": 1, "start_gap_cost": 1},
]


def _ec(cd):
    return EditCosts(cd["mismatch_cost"], cd["gap_cost"],
                     cd["start_gap_cost"], None)


@pytest.mark.parametrize("ci", range(len(COSTS)))
def test_distance_matches_oracle(ci):
    cd = COSTS[ci]
    rng = np.random.default_rng(100 + ci)
    a = [random_acgt(rng, int(rng.integers(0, 60))) for _ in range(30)]
    b = [edit_acgt(x, int(rng.integers(0, 12)), rng) if len(x) > 12
         else random_acgt(rng, int(rng.integers(0, 50))) for x in a]
    got = gap_affine_distances(a, b, cd, block=7)
    ref = [levenshtein_naive_with_opts(x, y, False, _ec(cd))[0]
           for x, y in zip(a, b)]
    assert got.tolist() == ref


def test_distance_band_control_differs():
    cd = COSTS[0]
    rng = np.random.default_rng(5)
    a = [random_acgt(rng, 400) for _ in range(6)]
    b = [edit_acgt(x, 40, rng) for x in a]
    exact = gap_affine_distances(a, b, cd)
    banded = gap_affine_distances(a, b, cd, band=2)
    assert (banded >= exact).all() and (banded > exact).any()


def _hay(rng, n):
    alph = ACGT[: int(rng.integers(1, 5))]
    if rng.random() < 0.5:  # periodic with a few flips: many ties
        per = alph[rng.integers(0, len(alph), int(rng.integers(1, 5)))]
        hay = np.resize(per, n).copy()
        flip = rng.random(n) < 0.05
        hay[flip] = ACGT[rng.integers(0, 4, int(flip.sum()))]
        return hay
    return alph[rng.integers(0, len(alph), n)]


@pytest.mark.parametrize("ci", range(len(COSTS)))
def test_search_matches_oracle(ci):
    cd = COSTS[ci]
    rng = np.random.default_rng(200 + ci)
    checked = 0
    for _ in range(40):
        n = int(rng.integers(1, 250))
        hay = _hay(rng, n)
        needles = []
        for _ in range(3):
            m = int(rng.integers(1, 30))
            if n > m and rng.random() < 0.7:
                p = int(rng.integers(0, n - m + 1))
                nd = hay[p: p + m].copy()
                if m > 8:
                    nd = edit_acgt(nd, int(rng.integers(0, 3)), rng)
            else:
                nd = random_acgt(rng, m)
            needles.append(nd)
        k = int(rng.integers(0, 16))
        best = bool(rng.random() < 0.5)
        try:
            got = search_matches(needles, hay, k, cd, best)
        except ValueError:  # no exact filter at this (m, k)
            continue
        st = SearchType.Best if best else SearchType.All
        for nd, g in zip(needles, got):
            ref = levenshtein_search_naive_with_opts(nd, hay, k, st,
                                                     _ec(cd), False)
            assert g == [(x.start, x.end, x.k) for x in ref]
            checked += 1
    assert checked >= 40


def test_filter_pieces_leave_one_untouched():
    # the cells' own needles: 61 pieces of 49 bytes for a 3,000-byte read
    # at k=240 under (4, 2, 6); 3 pieces for a primer at k=2, unit costs
    assert filter_pieces(3000, 240, COSTS[0]) == 61
    assert filter_pieces(18, 2, COSTS[1]) == 3
    with pytest.raises(ValueError):
        filter_pieces(4, 4, COSTS[1])
