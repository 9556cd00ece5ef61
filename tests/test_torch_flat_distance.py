"""Kernel K9 of the PyTorch/CUDA port (ops/search_flat.py, distance mode)
and the general-cost distance route past the band plan, on the CPU.

K9's plain version, `flat_distance_plain` (the kernel's column strips and
row windows, vectorised over the pairs), is held against the oracle over
the full matrix and banded, at several strip widths; against the JAX
package's public `levenshtein_k_batch` (its band scan on the CPU) inside
the band plan; and on the band-entry repro and bursts of exactly unit_k
inserted chars, where the JAX package's banded kernel is known to lose a
path (ROADMAP.md Queue 3).  Then `levenshtein_k_batch` and the single-pair
wrappers past the plan: the dispatch log reads `flat_distance`, the
result equals the compiled scalar distance of native/.  Integer results,
exact.
"""

import importlib

import numpy as np
import pytest
import torch

from triple_accel_tpu.types import EditCosts as JEditCosts

from triple_accel_tpu_torch.dispatch import dispatch_history
from triple_accel_tpu_torch.ops import search_flat as sf
from triple_accel_tpu_torch.oracle import levenshtein_naive_k_with_opts
from triple_accel_tpu_torch.types import EditCosts
from triple_accel_tpu_torch.utils.native import scalar_banded_batch_native

# one intra-op thread: the test workers run side by side on the
# machine's cores
torch.set_num_threads(1)

jl = importlib.import_module("triple_accel_tpu.levenshtein")
tl = importlib.import_module("triple_accel_tpu_torch.levenshtein")

CPU = dict(device="cpu")
COSTS = [(1, 1, 0, None), (1, 1, 0, 1), (2, 1, 2, None), (3, 2, 1, 2)]
IDS = ["unit", "rdamerau", "affine", "affine_transpose"]


def _ct(c):
    return tl._costs_tuple(EditCosts(*c))


def _oracle(a, b, c):
    return levenshtein_naive_k_with_opts(a, b, 10**9, False,
                                         EditCosts(*c))[0]


def _pairs(rng, n_pairs, max_len, n_edits):
    a_list, b_list = [], []
    for _ in range(n_pairs):
        a = rng.integers(0, 3, int(rng.integers(0, max_len))).astype(np.uint8)
        b = a.copy()
        for _ in range(int(rng.integers(0, n_edits + 1))):
            op = int(rng.integers(0, 4))
            if op == 0 and len(b):
                b[rng.integers(0, len(b))] = rng.integers(0, 3)
            elif op == 1:
                b = np.insert(b, rng.integers(0, len(b) + 1),
                              rng.integers(0, 3)).astype(np.uint8)
            elif op == 2 and len(b):
                b = np.delete(b, rng.integers(0, len(b)))
            elif len(b) > 1:
                q = int(rng.integers(0, len(b) - 1))
                b[q], b[q + 1] = b[q + 1], b[q]
        if len(a) > len(b):
            a, b = b, a
        a_list.append(a)
        b_list.append(b)
    return a_list, b_list


@pytest.mark.parametrize("c", COSTS, ids=IDS)
def test_full_matrix_equals_the_oracle(c):
    rng = np.random.default_rng(31)
    a_list, b_list = _pairs(rng, 10, 60, 8)
    a_list[0], b_list[1] = np.empty(0, np.uint8), np.empty(0, np.uint8)
    a_list[2][:2] = 0  # NUL bytes: pads are 0 too
    t = sf.prepare_flat_distance_inputs(a_list, b_list, device="cpu")
    exp = [_oracle(a, b, c) for a, b in zip(a_list, b_list)]
    for rj in (4, 16, None):  # several strips, and the kernel's one
        got = sf.flat_distance_plain(*t, costs_t=_ct(c), rj=rj)
        assert got.tolist() == exp, rj
    assert sf.flat_distance(*t, costs_t=_ct(c)).tolist() == exp


@pytest.mark.parametrize("c", COSTS, ids=IDS)
def test_banded_is_exact_within_the_threshold(c):
    """Banded by the unit_k that a threshold k gives (the dispatch's rule):
    every pair within k is exact, the others come back above k."""
    rng = np.random.default_rng(32)
    a_list, b_list = _pairs(rng, 12, 80, 10)
    t = sf.prepare_flat_distance_inputs(a_list, b_list, device="cpu")
    ct = _ct(c)
    exp = np.array([_oracle(a, b, c) for a, b in zip(a_list, b_list)])
    for k in (3, 8, 20):
        uk = max(k - ct[2], 0) // ct[1]
        for rj in (4, 8, 64):
            got = sf.flat_distance_plain(*t, costs_t=ct, unit_k=uk,
                                         rj=rj).numpy()
            feasible = np.array([len(b) - len(a) <= uk
                                 for a, b in zip(a_list, b_list)])
            within = feasible & (exp <= k)
            assert np.array_equal(got[within], exp[within]), (k, rj)
            assert bool((got[~within] > np.minimum(exp[~within], k)).all()
                        | ~feasible[~within].any())


def test_band_entry_repro_keeps_the_path_along_the_band_edge():
    """a = X^500, b = Y^32 + X^500 at unit_k = 32: the only path of cost 32
    runs along the band's edge.  The JAX package's banded `flat_distance`
    seeds the row above a strip's band window with INF and gives 33 here
    at rj = 64 (ROADMAP.md Queue 3, search_flat.py:575); the port's plain
    version keeps the real edges and gives the oracle's 32 at every strip
    width, as the rehearsed kernel body does (test_torch_host_rehearsal)."""
    a = np.full(500, ord("X"), np.uint8)
    b = np.concatenate([np.full(32, ord("Y"), np.uint8), a])
    t = sf.prepare_flat_distance_inputs([a], [b], device="cpu")
    assert _oracle(a, b, COSTS[0]) == 32
    for rj in (16, 64, 100, None):
        got = sf.flat_distance_plain(*t, costs_t=_ct(COSTS[0]), unit_k=32,
                                     rj=rj)
        assert got.tolist() == [32], rj


@pytest.mark.parametrize("where", ["front", "middle"])
def test_burst_of_exactly_unit_k_inserted_chars(where):
    """A copy with a burst of exactly unit_k inserted chars, banded at
    unit_k: the path runs on the band's edge for the burst's length."""
    rng = np.random.default_rng(33)
    a = rng.integers(0, 4, 400).astype(np.uint8)
    burst = rng.integers(0, 4, 24).astype(np.uint8)
    at = 0 if where == "front" else 200
    b = np.insert(a, at, burst)
    t = sf.prepare_flat_distance_inputs([a], [b], device="cpu")
    for c in COSTS:
        exp = int(scalar_banded_batch_native([a], [b], 10**6,
                                             EditCosts(*c))[0])
        assert exp <= 24 * c[1] + c[2]
        for rj in (16, 64, None):
            got = sf.flat_distance_plain(*t, costs_t=_ct(c), unit_k=24,
                                         rj=rj)
            assert got.tolist() == [exp], (c, rj)


def test_plain_version_equals_the_jax_band_scan_inside_the_plan():
    rng = np.random.default_rng(34)
    a_list, b_list = _pairs(rng, 16, 120, 12)
    for c in COSTS[2:]:
        k = 14
        ref = np.asarray(jl.levenshtein_k_batch(a_list, b_list, k,
                                                JEditCosts(*c)))
        t = sf.prepare_flat_distance_inputs(a_list, b_list, device="cpu")
        ct = _ct(c)
        got = sf.flat_distance(*t, costs_t=ct,
                               unit_k=(k - ct[2]) // ct[1]).numpy()
        assert np.array_equal(np.where(got <= k, got, -1), ref)


def test_k_batch_past_the_band_plan_takes_flat_distance():
    """Affine costs at an unbounded threshold on pairs longer than the
    band plan (unit_k past 4096): the dispatch log reads `flat_distance`
    and the distances equal the compiled scalar distance."""
    rng = np.random.default_rng(35)
    a = rng.integers(0, 4, 4150).astype(np.uint8)
    b = np.insert(a.copy(), [5, 2000, 2001], [1, 2, 3]).astype(np.uint8)
    b[3000:3040] = 0
    costs = EditCosts(2, 1, 2, None)
    exp = int(scalar_banded_batch_native([a], [b], 10**6, costs)[0])
    dispatch_history(clear=True)
    got = tl.levenshtein_k_batch([a, b[:10]], [b, a[:12]], 10**6, costs,
                                 **CPU)
    assert dispatch_history()[-1][1].path == "flat_distance"
    assert got.tolist() == [exp, _oracle(b[:10], a[:12], (2, 1, 2, None))]
    assert tl.levenshtein_simd_k_with_opts(a, b, (1 << 32) - 1, False,
                                           costs, **CPU) == (exp, None)


def test_wrapper_rules():
    t = sf.prepare_flat_distance_inputs([b"ab"], [b"abc"], device="cpu")
    ct = _ct(COSTS[2])
    with pytest.raises(ValueError, match="unit_k"):
        sf.flat_distance(*t, costs_t=ct, unit_k=-2)
    with pytest.raises(TypeError):
        sf.flat_distance(t[0].to(torch.int32), *t[1:], costs_t=ct)
    with pytest.raises(ValueError, match="unsupported device"):
        sf.flat_distance(*(x.to("meta") for x in t), costs_t=ct)
    with pytest.raises(ValueError, match="u8 range"):
        sf.flat_distance(*t, costs_t=(300, 1, 0, 0, False))
    assert sf.flat_distance(*t, costs_t=ct).tolist() == [3]  # 1 gap: 2 + 1
    assert sf.flat_distance.launches == 0  # the plain version counts none
    # a lane for every DIST_COLS columns, whole warps, 64 to the cap
    assert sf.flat_threads(20_000) == sf.DIST_MAX_THREADS
    assert sf.flat_threads(1) == 64
    assert sf.flat_threads(32 * 3 * sf.DIST_COLS) == 96
    assert sf.flat_threads(32 * 3 * sf.DIST_COLS + 1) == 128
    assert sf.DIST_MAX_THREADS <= sf.max_threads(False, sf.DIST_COLS)


def test_empty_strings_take_the_boundary():
    t = sf.prepare_flat_distance_inputs(
        [b"", b"", b"abc"], [b"", b"xyz", b""], device="cpu")
    got = sf.flat_distance(*t, costs_t=_ct(COSTS[3]))
    assert got.tolist() == [0, 3 * 2 + 1, 3 * 2 + 1]
