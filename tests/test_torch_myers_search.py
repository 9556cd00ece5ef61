"""Kernel K2 of the PyTorch/CUDA port (ops/myers_search.py) on the CPU.

The port's plain PyTorch version — the code the CUDA kernel is held against
on the card — against the scalar oracle's All-mode (end, k) map and against
the JAX package's Pallas search kernel (interpret mode, chains=1) on the
same needles and haystack.  Integer results, exact equality: every end
position the oracle reports has exactly its distance, and the port reports
no other position within k.
"""

import numpy as np
import pytest
import torch

from triple_accel_tpu.oracle import levenshtein_search_naive_with_opts
from triple_accel_tpu.ops.pallas.search_myers import (
    myers_search_pallas,
    myers_search_plan as jax_search_plan,
    prepare_myers_needles as jax_prepare_needles,
    prepare_myers_search_inputs,
)
from triple_accel_tpu.types import (
    LEVENSHTEIN_COSTS,
    RDAMERAU_COSTS,
    SearchType,
)

from triple_accel_tpu_torch.ops.myers_search import (
    collect_hits,
    from_reference_needles,
    myers_search,
    myers_search_plan,
    prepare_myers_needles,
    search_halo,
    suggest_own_len,
)
from triple_accel_tpu_torch.ops.search_common import seg_count, window_span

# one intra-op thread: the test workers run side by side on the
# machine's cores
torch.set_num_threads(1)


def _oracle_map(needle, hay, k, costs, anchored):
    return {
        mt.end: mt.k
        for mt in levenshtein_search_naive_with_opts(
            needle, hay, k, SearchType.All, costs, anchored)
    }


def _port_dists(needles, hay, k, *, anchored, damerau, own_len):
    m, n = len(needles[0]), len(hay)
    if anchored:
        iter_len, halo, own_len = min(m + k, n), 0, max(min(m + k, n), 1)
    else:
        iter_len, halo = n, min(window_span(m, k, 1, 0), n)
    nd = prepare_myers_needles(needles, m, device="cpu")
    out = myers_search(torch.from_numpy(hay[:iter_len].copy()), nd,
                       own_len=own_len, halo=halo, anchored=anchored,
                       damerau=damerau)
    assert out.shape == (len(needles), iter_len + 1)
    return out


def test_plan_and_geometry():
    assert myers_search_plan(0) is None
    assert myers_search_plan(24) == (1,)
    assert myers_search_plan(64) == (2,)
    assert myers_search_plan(65) == (3,)
    assert myers_search_plan(400) == (16,)  # 13 words: the next built count
    assert myers_search_plan(1280) == (40,)
    assert myers_search_plan(1281) is None
    assert all(myers_search_plan(m)[0] * 32 >= m for m in range(1, 1281))
    assert window_span(24, 3, 1, 0) == 27
    assert search_halo(27, 1 << 20) == 32 and search_halo(33, 1 << 20) == 64
    assert search_halo(27, 20) == 20
    assert seg_count(0, 64) == 1 and seg_count(129, 64) == 3
    own = suggest_own_len(128 << 20, 32)
    assert own == 2048 and seg_count(128 << 20, own) == 64 * 1024
    assert suggest_own_len(1 << 20, 32) == 256  # a small haystack
    assert suggest_own_len(128 << 20, 512) == 4096  # halo / own_len 1/8


@pytest.mark.parametrize("anchored", [False, True])
@pytest.mark.parametrize("damerau", [False, True])
@pytest.mark.parametrize("m_lo,m_hi", [(1, 20), (21, 64), (65, 100)])
def test_plain_matches_oracle(m_lo, m_hi, damerau, anchored):
    """Every cost model and mode, one- and multi-word needles, several
    segments per haystack (own_len far below the haystack length)."""
    costs = RDAMERAU_COSTS if damerau else LEVENSHTEIN_COSTS
    rng = np.random.default_rng(m_lo + 7 * damerau + 13 * anchored)
    for _ in range(3):
        m = int(rng.integers(m_lo, m_hi + 1))
        n = int(rng.integers(0, 260))
        needle = rng.integers(65, 69, m).astype(np.uint8)
        hay = rng.integers(65, 69, n).astype(np.uint8)
        if n > m + 2:
            pos = int(rng.integers(0, n - m))
            hay[pos:pos + m] = needle
            if m > 3:  # a planted transposition
                hay[pos + 1], hay[pos + 2] = hay[pos + 2], hay[pos + 1]
        k = min(m, 5)
        out = _port_dists([needle], hay, k, anchored=anchored,
                          damerau=damerau, own_len=48)
        exp = _oracle_map(needle, hay, k, costs, anchored)
        _, gpos, d = collect_hits(out, k)
        assert dict(zip(gpos.tolist(), d.tolist())) == exp, (m, n, k)


@pytest.mark.parametrize("damerau", [False, True])
def test_nul_needle_against_nul_haystack_start(damerau):
    """A needle holding 0x00 over a haystack that starts with 0x00: no
    synthetic pad exists before segment 0, so nothing is deflated."""
    costs = RDAMERAU_COSTS if damerau else LEVENSHTEIN_COSTS
    rng = np.random.default_rng(5)
    needle = rng.integers(65, 68, 9).astype(np.uint8)
    needle[[0, 4]] = 0
    hay = rng.integers(65, 68, 150).astype(np.uint8)
    hay[:3] = 0
    hay[70:79] = needle
    k = 4
    out = _port_dists([needle], hay, k, anchored=False, damerau=damerau,
                      own_len=32)
    _, gpos, d = collect_hits(out, k)
    assert dict(zip(gpos.tolist(), d.tolist())) == _oracle_map(
        needle, hay, k, costs, False)


@pytest.mark.parametrize("m,damerau", [(9, False), (24, True), (70, False)])
def test_plain_matches_pallas_interpret(m, damerau):
    """Two needles in one call, decoded with the JAX package's own decode:
    on one whole-haystack segment both kernels emit D[m][j] for every j,
    so the arrays are equal element for element.  The needles reach the
    port through from_reference_needles."""
    rng = np.random.default_rng(m)
    seg_len = 45
    hay = rng.integers(65, 69, seg_len).astype(np.uint8)
    needles = [rng.integers(65, 69, m).astype(np.uint8) for _ in range(2)]
    nchar = jax_prepare_needles(needles, m)
    _, seg_t, decode = prepare_myers_search_inputs(needles[0], hay[None, :])
    G = jax_search_plan(m)[2]
    width = seg_t.shape[0] // G
    raw = np.asarray(myers_search_pallas(
        nchar, seg_t, needle_len=m, width=width, seg_len=seg_len,
        anchored=False, num_needles=2, interpret=True, damerau=damerau,
        chains=1))
    rows = raw.shape[0] // 2
    ref = np.stack([decode(raw[i * rows:(i + 1) * rows], seg_len)[0]
                    for i in range(2)])
    nd = prepare_myers_needles(from_reference_needles(nchar, m), m,
                               device="cpu")
    assert np.array_equal(nd.numpy(), np.stack(needles))
    got = myers_search(torch.from_numpy(hay), nd, own_len=seg_len, halo=0,
                       damerau=damerau).numpy()
    assert np.array_equal(got, ref)


@pytest.mark.parametrize("m,k,damerau", [(24, 3, False), (24, 3, True),
                                         (40, 5, False)])
def test_halo_rule_matches_pallas_interpret_and_oracle(m, k, damerau):
    """The dispatch's halo rule (the window span rounded up to 32) over
    many segments of whole store runs: every end position within k of the
    JAX package's kernel (one whole-haystack segment, interpret mode) has
    the same distance in the port and no other is within k, and the hits
    equal the oracle's."""
    costs = RDAMERAU_COSTS if damerau else LEVENSHTEIN_COSTS
    rng = np.random.default_rng(100 + m + k)
    n = 200
    needle = rng.integers(65, 69, m).astype(np.uint8)
    hay = rng.integers(65, 69, n).astype(np.uint8)
    for pos in (5, 70, 140):  # copies across segment edges, one swapped
        hay[pos:pos + m] = needle
    hay[72], hay[73] = hay[73], hay[72]
    halo = search_halo(window_span(m, k, 1, 0), n)
    assert halo % 32 == 0 and halo >= window_span(m, k, 1, 0)
    nd = prepare_myers_needles([needle], m, device="cpu")
    got = myers_search(torch.from_numpy(hay), nd, own_len=32, halo=halo,
                       damerau=damerau).numpy()[0]
    nchar = jax_prepare_needles([needle], m)
    _, seg_t, decode = prepare_myers_search_inputs(needle, hay[None, :])
    G = jax_search_plan(m)[2]
    raw = np.asarray(myers_search_pallas(
        nchar, seg_t, needle_len=m, width=seg_t.shape[0] // G, seg_len=n,
        anchored=False, num_needles=1, interpret=True, damerau=damerau,
        chains=1))
    ref = decode(raw, n)[0]
    within = (ref <= k) | (got <= k)
    assert within.sum() >= 3
    assert np.array_equal(got[within], ref[within])
    exp = _oracle_map(needle, hay, k, costs, False)
    assert {j: int(got[j]) for j in np.flatnonzero(got <= k)} == exp


def test_wrapper_checks_its_inputs():
    hay = torch.zeros(10, dtype=torch.uint8)
    nd = torch.zeros((1, 3), dtype=torch.uint8)
    with pytest.raises(ValueError):
        myers_search(hay, nd, own_len=4, halo=0, anchored=True)
    with pytest.raises(TypeError):
        myers_search(hay.to(torch.int32), nd, own_len=16, halo=0)
    with pytest.raises(ValueError):
        myers_search(hay, torch.zeros((1, 1281), dtype=torch.uint8),
                     own_len=16, halo=0)
    with pytest.raises(ValueError):
        myers_search(hay, nd, own_len=16, halo=0, warps=9)
    assert myers_search(hay[:0], nd, own_len=16, halo=0).tolist() == [[3]]
    assert myers_search.launches == 0  # CPU tensors never launch
