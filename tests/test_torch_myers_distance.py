"""Kernel K1 of the PyTorch/CUDA port (ops/myers_distance.py) on the CPU.

The same numpy inputs go through the JAX package's Pallas kernel (interpret
mode, chains=1) and, through `from_reference_batch`, through the port's
plain PyTorch version — the code the CUDA kernel is held against on the
card.  Integer results: the tolerance is exact equality wherever the oracle
distance is <= k, and "> k" otherwise (the band contract both kernels
share: exact within the threshold, never below the truth above it).
"""

import numpy as np
import pytest
import torch

import chip_smoke as cs

from triple_accel_tpu.ops.pallas.lev_myers import (
    myers_distance_pallas,
    prepare_myers_inputs as jax_prepare,
)
from triple_accel_tpu.oracle import levenshtein_naive_k_with_opts

from triple_accel_tpu_torch.ops.myers_distance import (
    from_reference_batch,
    myers_distance,
    myers_distance_plain,
    myers_plan,
    prepare_myers_inputs,
)

# one intra-op thread: the test workers run side by side on the
# machine's cores
torch.set_num_threads(1)


def _corpus(rng, n_pairs, max_m, k, lo=65, hi=70, nul=False):
    a_list, b_list = [], []
    while len(a_list) < n_pairs:
        m = int(rng.integers(0, max_m))
        a = rng.integers(lo, hi, m).astype(np.uint8)
        if nul and m:
            a[rng.integers(0, m, 2)] = 0  # NUL chars: pads are 0 too
        b = list(a)
        for _ in range(int(rng.integers(0, 10))):
            op = rng.integers(0, 3)
            if op == 0 and b:
                b[rng.integers(0, len(b))] = rng.integers(lo, hi)
            elif op == 1 and len(b) < max_m - 1:
                b.insert(int(rng.integers(0, len(b) + 1)),
                         int(rng.integers(lo, hi)))
            elif op == 2 and b:
                del b[rng.integers(0, len(b))]
        b = np.array(b, dtype=np.uint8)
        if len(a) > len(b):
            a, b = b, a
        if len(b) - len(a) > k or len(a) > max_m:
            continue
        a_list.append(a)
        b_list.append(b)
    return a_list, b_list


def _oracle(a_list, b_list):
    return [levenshtein_naive_k_with_opts(a, b, 10**9, False)[0]
            for a, b in zip(a_list, b_list)]


def _assert_band_contract(got, exp, ks):
    for p, (g, e, kp) in enumerate(zip(got, exp, ks)):
        if e <= kp:
            assert g == e, f"pair {p}: {g} != {e} (k={kp})"
        else:
            assert g > kp, f"pair {p}: false accept {g} <= {kp} < {e}"
        assert g >= e, f"pair {p}: {g} below the truth {e}"


def test_plan_covers_the_reference_ceiling():
    assert myers_plan(0) == (1, 64)
    assert myers_plan(32) == (1, 64)
    assert myers_plan(63) == (1, 64)
    assert myers_plan(64) == (2, 128)
    assert myers_plan(159) == (3, 192)  # the TPU kernel's ceiling
    assert myers_plan(191) == (3, 192)
    assert myers_plan(192) is None


@pytest.mark.parametrize("k,max_m", [(4, 16), (16, 48), (32, 64), (159, 32)])
def test_plain_matches_pallas_interpret_and_oracle(k, max_m):
    """Same bytes through both kernels: the JAX prep's arrays feed the
    Pallas kernel and, via from_reference_batch, the port."""
    rng = np.random.default_rng(100 + k)
    a_list, b_list = _corpus(rng, 60, max_m, k)
    exp = _oracle(a_list, b_list)
    *jargs, jdecode = jax_prepare(a_list, b_list, k, max_m)
    ref = np.asarray(jdecode(
        myers_distance_pallas(*jargs, k=k, max_m=max_m, interpret=True,
                              chains=1)))[: len(a_list)]
    tensors, decode = from_reference_batch(*jargs, k=k, max_m=max_m,
                                           device="cpu")
    got = decode(myers_distance(*tensors, k=k))[: len(a_list)]
    _assert_band_contract(got, exp, [k] * len(exp))
    _assert_band_contract(ref, exp, [k] * len(exp))
    within = np.asarray(exp) <= k
    assert np.array_equal(got[within], ref[within])
    # the port's own prep sees the same pairs and gives the same answers
    own = myers_distance(
        *prepare_myers_inputs(a_list, b_list, k, max_m, device="cpu"), k=k
    ).numpy()
    assert np.array_equal(own, got)


@pytest.mark.parametrize("k", [0, 31, 63, 64, 127, 128, 191])
def test_word_boundaries_and_nul_bytes(k):
    """k + 1 at and around a multiple of the 64-bit word (and of the plain
    version's 32-bit container word), strings with NUL bytes."""
    rng = np.random.default_rng(7 + k)
    max_m = 72
    a_list, b_list = _corpus(rng, 80, max_m, k, nul=True)
    exp = _oracle(a_list, b_list)
    t = prepare_myers_inputs(a_list, b_list, k, max_m, device="cpu")
    got = myers_distance_plain(*t, k=k).numpy()
    _assert_band_contract(got, exp, [k] * len(exp))


def test_edge_pairs_and_per_pair_thresholds():
    cases = [
        (b"", b""),
        (b"", b"abc"),
        (b"a", b"a"),
        (b"a", b"b"),
        (b"ab", b"ba"),
        (b"x" * 30, b"x" * 33),
        (b"\x00\x00a", b"\x00a\x00\x00"),
        (b"abcdefgh", b"abcdefghijklmnop"),  # len(b) - len(a) == k_pair
    ]
    k, max_m = 8, 32
    a_list = [np.frombuffer(a, dtype=np.uint8) for a, _ in cases]
    b_list = [np.frombuffer(b, dtype=np.uint8) for _, b in cases]
    exp = _oracle(a_list, b_list)
    t = prepare_myers_inputs(a_list, b_list, k, max_m, device="cpu")
    got = myers_distance(*t, k=k).numpy()
    assert got.tolist() == exp
    # per-pair thresholds below k narrow each pair's band; the contract
    # then holds per pair
    ks = np.array([0, 3, 0, 1, 2, 3, 2, 8])
    t = prepare_myers_inputs(a_list, b_list, k, max_m, ks=ks, device="cpu")
    got = myers_distance(*t, k=k).numpy()
    _assert_band_contract(got, exp, ks)


def test_wrapper_checks_its_inputs():
    a = [np.frombuffer(b"abc", dtype=np.uint8)]
    t = list(prepare_myers_inputs(a, a, 4, 8, device="cpu"))
    with pytest.raises(ValueError):
        myers_distance(*t, k=192)
    with pytest.raises(TypeError):
        myers_distance(t[0].to(torch.int32), *t[1:], k=4)
    with pytest.raises(ValueError):
        prepare_myers_inputs([a[0]], [np.zeros(20, np.uint8)], 4, 8,
                             device="cpu")
    assert myers_distance.launches == 0  # CPU tensors never launch


def test_k1_k2_edge_cases_cover_their_edges():
    """The K1 edge pairs put every length at ukL 0, 1 and k // 2 inside
    the kernel's contract; the K2 edge shapes cover every built word
    count's edge, haystacks one under and over multiples of 32, owned
    lengths off the 16-byte chunk and halos reaching byte 0, and their
    inputs hold the planted copies."""
    from triple_accel_tpu_torch.ops.myers_search import (
        WORD_CHOICES, myers_search_plan)
    from triple_accel_tpu_torch.ops.search_common import window_span

    rng = np.random.default_rng(8)
    for k in cs.DIST_EDGE_KS:
        a_list, b_list, ks, max_m = cs.distance_edge_cases(rng, k)
        la = np.array([len(a) for a in a_list])
        delta = np.array([len(b) for b in b_list]) - la
        assert ((0 <= delta) & (delta <= ks) & (ks <= k)).all()
        assert (la <= max_m).all()
        ukl = (ks - delta) // 2
        for m in cs.DIST_EDGE_LENS:
            assert set(ukl[la == m].tolist()) == {0, 1, k // 2}
    cases = cs.SEARCH_EDGE_CASES
    assert {myers_search_plan(c[0])[0] for c in cases} >= set(WORD_CHOICES) - {24}
    assert {c[1] % 32 for c in cases if not c[4]} >= {1, 31}
    assert any(c[2] % 16 for c in cases) and any(c[3] > c[2] for c in cases)
    assert {c[6] for c in cases} >= {1, 8} and any(c[4] for c in cases)
    for m, n, own, halo, anchored, _d, _w in cases:
        assert anchored or halo >= window_span(m, 3, 1, 0)
        needles, hay = cs.search_edge_input(rng, m, n)
        assert needles.shape == (2, m) and hay.shape == (n,)
        assert 0 in needles[1] and hay[0] == 0
        if n > m + 2:
            assert np.sum(hay[1:1 + m] != needles[0]) <= 2  # one swap
