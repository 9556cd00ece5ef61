"""Traced batches at the exact band, on the CPU.

A traced call of the port runs the band kernel K4 and the walk K10 at the
batch's unit_k rounded up to 16, where the JAX package rounds it up to a
power of two (its static shapes).  A cell at |j - i| > unit_k costs more
than the pair's threshold, so no traceback of a pair within its threshold
passes through one, and at an unbounded threshold both bands cover the
whole matrix: the distances and `Edit` lists stay the JAX package's.  That
is held here, not assumed: `levenshtein_k_batch` with `trace_on=True` and
the single-pair traced wrappers against the JAX functions and the scalar
oracle on batches whose unit_k is not a power of two and whose threshold
binds, and the port's own plain scan and walk at the exact band against
the same at the power of two.  Tolerance: exact.
"""

import importlib

import numpy as np
import pytest
import torch

from triple_accel_tpu.types import EditCosts as JEditCosts

from triple_accel_tpu_torch.dispatch import last_dispatch
from triple_accel_tpu_torch.ops import band_scan as tbs
from triple_accel_tpu_torch.ops import lev_band as tlb
from triple_accel_tpu_torch.types import EditCosts

from test_torch_band_distance import COSTS, COST_IDS, _ct
from test_torch_band_trace import _fields, _oracle, _replay_cost

# one intra-op thread: the test workers run side by side on the
# machine's cores
torch.set_num_threads(1)

jl = importlib.import_module("triple_accel_tpu.levenshtein")
tl = importlib.import_module("triple_accel_tpu_torch.levenshtein")

CPU = dict(device="cpu")


def _k_for(c, unit_k):
    """The threshold whose per-pair band is `unit_k` under costs `c`:
    uks = (k - start_gap) // gap."""
    return unit_k * c[1] + c[2]


def _edited(rng, n_pairs, lo, hi, n_subs, max_ins):
    """ACGT-like copies with substitutions, adjacent swaps and insertions
    (so that n - m spreads over the band), NUL bytes in every fifth a."""
    a_list, b_list = [], []
    for p in range(n_pairs):
        m = int(rng.integers(lo, hi + 1))
        a = rng.integers(65, 69, m).astype(np.uint8)
        if p % 5 == 4:
            a[rng.integers(0, m, 2)] = 0
        b = a.copy()
        b[rng.integers(0, m, int(rng.integers(0, n_subs + 1)))] = 66
        for q in rng.integers(0, m - 1, 3).tolist():
            b[q], b[q + 1] = b[q + 1], b[q]
        ins = int(rng.integers(0, max_ins + 1))
        b = np.insert(b, rng.integers(0, m + 1, ins),
                      rng.integers(65, 69, ins).astype(np.uint8))
        a_list.append(a)
        b_list.append(b)
    return a_list, b_list


def _check_against_jax_and_oracle(a_list, b_list, k, c, dists, traces):
    d_ref, tr_ref = jl.levenshtein_k_batch(a_list, b_list, k,
                                           JEditCosts(*c), True)
    assert dists.tolist() == np.asarray(d_ref).tolist()
    assert [_fields(t) for t in traces] == [_fields(t) for t in tr_ref]
    for p, (a, b) in enumerate(zip(a_list, b_list)):
        exp_d, exp_tr = _oracle(a, b, k, c)
        assert int(dists[p]) == exp_d and _fields(traces[p]) == exp_tr
        if exp_d >= 0 and c[2] == 0:
            assert _replay_cost(a, b, exp_tr, c) == exp_d


# batches whose unit_k (40 or 70 before rounding) is not a power of two
# after it (48, 80) and whose threshold binds: uks < n for every pair, and
# some pairs fall outside it (-1, None); pairs in both orders
@pytest.mark.parametrize("uk_pairs,uk_dev", [(40, 48), (70, 80)])
@pytest.mark.parametrize("c", COSTS, ids=COST_IDS)
def test_k_batch_traced_at_the_exact_band_equals_jax_and_oracle(c, uk_pairs,
                                                                uk_dev):
    rng = np.random.default_rng(900 + uk_pairs + c[0] + 7 * c[2])
    a_list, b_list = _edited(rng, 24, 90, 150, 30, uk_pairs)
    for p in range(0, 24, 3):
        a_list[p], b_list[p] = b_list[p], a_list[p]
    k = _k_for(c, uk_pairs)
    dists, traces = tl.levenshtein_k_batch(a_list, b_list, k, EditCosts(*c),
                                           True, **CPU)
    dec = last_dispatch()
    assert dec.path == "band_trace" and dec.unit_k == uk_dev
    assert (dists >= 0).any() and (dists == -1).any()
    assert min(max(len(a), len(b)) for a, b in zip(a_list, b_list)) \
        > uk_pairs
    _check_against_jax_and_oracle(a_list, b_list, k, c, dists, traces)


@pytest.mark.parametrize("c", COSTS, ids=COST_IDS)
def test_single_pair_traced_wrappers_at_the_exact_band(c):
    """`levenshtein_simd_k_with_opts` (thresholds whose band is 17, 33 and
    52 cells a side: unit_k 32, 48, 64) and `levenshtein_exp_with_opts`
    (its rungs double k) against the JAX package and the oracle."""
    rng = np.random.default_rng(40 + c[0] + 7 * c[2])
    a_list, b_list = _edited(rng, 3, 100, 130, 25, 45)
    for a, b in zip(a_list, b_list):
        for uk in (17, 33, 52):
            k = _k_for(c, uk)
            got = tl.levenshtein_simd_k_with_opts(a, b, k, True,
                                                  EditCosts(*c), **CPU)
            ref = jl.levenshtein_simd_k_with_opts(a, b, k, True,
                                                  JEditCosts(*c))
            exp_d, exp_tr = _oracle(a, b, k, c)
            if exp_d < 0:
                assert got is None and ref is None
                continue
            assert last_dispatch().unit_k == -(-uk // 16) * 16
            assert got[0] == ref[0] == exp_d
            assert _fields(got[1]) == _fields(ref[1]) == exp_tr
        got = tl.levenshtein_exp_with_opts(a, b, True, EditCosts(*c), **CPU)
        ref = jl.levenshtein_exp_with_opts(a, b, True, JEditCosts(*c))
        assert got[0] == ref[0] and _fields(got[1]) == _fields(ref[1])


@pytest.mark.parametrize("unit_k,expected", [
    (0, 0), (1, 16), (16, 16), (17, 32), (40, 48), (100, 112),
])
def test_traced_unit_k_is_rounded_up_to_16(unit_k, expected):
    """The band the traced route gives K4 and K10 (unit_k of the dispatch
    log); the untraced route keeps the power of two."""
    a = np.full(unit_k + 2, 65, np.uint8)
    b = np.concatenate([a, np.full(unit_k, 66, np.uint8)])
    k = unit_k  # unit costs: uks = min(k, n) and n - m == unit_k
    dists, traces = tl.levenshtein_k_batch([a], [b], k, trace_on=True, **CPU)
    dec = last_dispatch()
    assert dec.path == "band_trace" and dec.unit_k == expected
    assert int(dists[0]) == unit_k and traces[0] is not None
    tl.levenshtein_k_batch([a], [b], k, **CPU)
    assert last_dispatch().unit_k == max(4, 1 << (unit_k - 1).bit_length())


# the port's plain scan and walk at the exact band equal themselves at the
# power of two for every pair within its threshold, and at an unbounded
# threshold (both bands cover the matrix)
@pytest.mark.parametrize("c", COSTS, ids=COST_IDS)
def test_walks_at_the_exact_band_equal_the_power_of_two(c):
    rng = np.random.default_rng(77 + c[0] + 7 * c[2])
    uk_pairs = 36
    a_list, b_list = _edited(rng, 20, 60, 100, 20, uk_pairs)
    a_list.append(np.full(30, 65, np.uint8))  # unbounded: n <= unit_k
    b_list.append(np.full(40, 67, np.uint8))
    ct = _ct(c)
    k = _k_for(c, uk_pairs)
    walked = {}
    for uk in (48, 64):  # the exact band and the power of two
        t = tlb.prepare_band_tensors(a_list, b_list, uk, 112, device="cpu")
        d, codes = tlb.band_trace(*t, unit_k=uk, costs_t=ct)
        seq, _ = tbs.walk_packed_traceback(codes, *t, unit_k=uk)
        walked[uk] = (d, tbs.decode_walked_batch(
            *tbs.run_length_encode(seq), [False] * len(a_list)))
    inside = [p for p in range(len(a_list))
              if int(walked[64][0][p]) <= k or p == len(a_list) - 1]
    assert len(inside) > 5
    for p in inside:
        assert int(walked[48][0][p]) == int(walked[64][0][p])
        assert _fields(walked[48][1][p]) == _fields(walked[64][1][p])
    assert torch.equal(walked[48][0][inside], walked[64][0][inside])
