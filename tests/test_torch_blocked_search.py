"""Kernel K6 of the PyTorch/CUDA port (ops/myers_chunked.py, search mode)
and the long-needle search route, on the CPU.

K6's plain version is K2's (`myers_search_plain`, which has no length cap:
the 1280-char cap belongs to K2's kernel wrapper).  It is held against the
JAX package's blocked Pallas kernel in interpret mode at one 260-column
shape (the chunked kernel is never run in interpret mode here: it costs
tens of seconds), and the JAX package's two long-needle layouts reach the
port through the bridge.  Then `levenshtein_search_simd_with_opts` with
needles of 1,281 to 1,500 chars over Best/All, unit/rDamerau and
anchored/unanchored (anchored with k >= m too): the dispatch log reads
`myers_search_blocked`, the matches equal the JAX package's public
function (its scan route) field for field and, in All mode, the compiled
scalar search of native/.  Integer results, exact equality.
"""

import importlib

import numpy as np
import pytest
import torch

from triple_accel_tpu.ops.pallas.myers_chunked import prepare_chunked_needles
from triple_accel_tpu.ops.pallas.search_myers import (
    blocked_search_pallas,
    prepare_blocked_needles,
    prepare_blocked_search_inputs,
)
from triple_accel_tpu.types import (
    LEVENSHTEIN_COSTS as J_LEV,
    RDAMERAU_COSTS as J_RDAM,
    SearchType as JSearchType,
)

from triple_accel_tpu_torch.dispatch import dispatch_history
from triple_accel_tpu_torch.ops import myers_chunked as mc
from triple_accel_tpu_torch.ops.myers_search import (
    myers_search,
    myers_search_plain,
    prepare_myers_needles,
)
from triple_accel_tpu_torch.oracle import levenshtein_search_naive_with_opts
from triple_accel_tpu_torch.types import (
    LEVENSHTEIN_COSTS,
    RDAMERAU_COSTS,
    SearchType,
)
from triple_accel_tpu_torch.utils.native import search_all_native

# one intra-op thread: the test workers run side by side on the
# machine's cores
torch.set_num_threads(1)

jl = importlib.import_module("triple_accel_tpu.levenshtein")
tl = importlib.import_module("triple_accel_tpu_torch.levenshtein")

CPU = dict(device="cpu")


def _as_tuples(matches):
    return [(m.start, m.end, m.k) for m in matches]


def test_own_len_and_the_bridges_of_both_layouts():
    own = mc.suggest_own_len_blocked(128 << 20, 3328)
    assert own % 256 == 0 and own >= 8 * 3328
    assert -(-(128 << 20) // own) <= 132 * 32  # one resident warp each
    assert mc.suggest_own_len_blocked(2000, 1536) == 8 * 1536
    assert mc.suggest_own_len_blocked(10, 0) == 1024
    rng = np.random.default_rng(1)
    m = 2600  # three of the JAX package's 1280-char strips
    needles = [rng.integers(0, 256, m).astype(np.uint8) for _ in range(2)]
    blocked = mc.from_reference_strip_needles(
        prepare_blocked_needles(needles, m), m, 2, strip_major=False)
    nchar, n_strips = prepare_chunked_needles(needles, m)
    assert n_strips == 3
    chunked = mc.from_reference_strip_needles(nchar, m, 2, strip_major=True)
    assert np.array_equal(blocked, np.stack(needles))
    assert np.array_equal(chunked, np.stack(needles))
    with pytest.raises(ValueError, match="pad"):
        mc.from_reference_strip_needles(nchar, m + 1, 2, strip_major=True)


def test_k2_cap_lives_in_its_wrapper_only():
    """K2's kernel stops at 1280 chars, its plain version does not: a
    1300-char needle runs through `myers_search_plain` (and so through
    K6's plain version) and equals the oracle, while `myers_search`
    refuses it and `blocked_search` takes it."""
    rng = np.random.default_rng(2)
    needle = rng.integers(0, 4, 1300).astype(np.uint8)
    hay = rng.integers(0, 4, 60).astype(np.uint8)
    hay[:30] = needle[-30:]
    nd = prepare_myers_needles([needle], 1300, **CPU)
    h = torch.from_numpy(hay)
    got = myers_search_plain(h, nd, own_len=60, halo=0).numpy()[0]
    exp = {mt.end: mt.k for mt in levenshtein_search_naive_with_opts(
        needle, hay, 1300, SearchType.All, LEVENSHTEIN_COSTS, False)}
    assert dict(enumerate(got.tolist())) == exp
    with pytest.raises(ValueError, match="1280"):
        myers_search(h, nd, own_len=60, halo=0)
    assert np.array_equal(mc.blocked_search(h, nd, own_len=60, halo=0)[0],
                          got)
    assert mc.blocked_search.launches == 0  # CPU tensors never launch


def test_plain_equals_jax_blocked_interpret():
    """The 260-column shape of the JAX package's own conformance test, the
    needle one char past its first strip, restricted-Damerau: the JAX
    kernel's D[m][j] row equals the port's, element for element; the
    needle reaches the port through the bridge."""
    m, n = 1281, 260
    rng = np.random.default_rng(m * 2 + 1)
    needle = rng.integers(0, 4, m).astype(np.uint8)
    hay = rng.integers(0, 4, n).astype(np.uint8)
    hay[30:200] = needle[:170]
    nchar, seg_t, width, _ = prepare_blocked_search_inputs(needle,
                                                           hay[None, :])
    ref = np.asarray(blocked_search_pallas(
        nchar, seg_t, needle_len=m, width=width, seg_len=n,
        anchored=False, interpret=True, damerau=True))[: n + 1, 0]
    nd = prepare_myers_needles(mc.from_reference_strip_needles(
        nchar, m, 1, strip_major=False), m, **CPU)
    got = mc.blocked_search(torch.from_numpy(hay), nd, own_len=n, halo=0,
                            damerau=True).numpy()[0]
    assert np.array_equal(got, ref)


@pytest.mark.parametrize("anchored", [False, True],
                         ids=["unanchored", "anchored"])
@pytest.mark.parametrize("damerau", [False, True], ids=["unit", "rdamerau"])
def test_long_needle_search_equals_jax_and_native(damerau, anchored):
    """Best and All mode, a planted copy with substitutions and an adjacent
    swap, NUL bytes in needle and haystack; anchored searches plant at 0,
    and the anchored restricted-Damerau case runs at k >= m (every end
    position is a candidate, end 0 included)."""
    costs, jcosts = ((RDAMERAU_COSTS, J_RDAM) if damerau
                     else (LEVENSHTEIN_COSTS, J_LEV))
    rng = np.random.default_rng(40 + 2 * damerau + anchored)
    m = int(rng.integers(1281, 1501))
    n = 1700
    needle = rng.integers(0, 4, m).astype(np.uint8)
    needle[rng.integers(0, m, 2)] = 0
    hay = rng.integers(0, 4, n).astype(np.uint8)
    hay[-1] = 0
    pos = 0 if anchored else 150
    copy = needle.copy()
    copy[rng.integers(0, m, 5)] = 2
    copy[10], copy[11] = copy[11], copy[10]
    hay[pos:pos + m] = copy
    k = m + 20 if anchored and damerau else 40
    for st in (SearchType.Best, SearchType.All):
        dispatch_history(clear=True)
        got = tl.levenshtein_search_simd_with_opts(needle, hay, k, st, costs,
                                                   anchored, **CPU)
        assert dispatch_history()[-1][1].path == "myers_search_blocked"
        ref = jl.levenshtein_search_simd_with_opts(
            needle, hay, k, JSearchType[st.name], jcosts, anchored)
        assert _as_tuples(got) == _as_tuples(ref)
        assert got, "the planted copy was not found"
        if st == SearchType.All:
            ends, ks, lens = search_all_native(needle, hay, k, costs,
                                               anchored=anchored)
            assert _as_tuples(got) == list(zip((ends - lens).tolist(),
                                               ends.tolist(), ks.tolist()))


def test_blocked_plan_covers_every_word_once():
    """K6's and K5's plans for needles of 1 to 4,200 chars (4 and 257
    table rows): every 32-bit word of the needle lies in one slot (strip,
    lane, word of the lane) and no two words in one; a search's group
    holds no lane the needle does not need (halving it would not hold the
    needle at its words a lane) and no map of fewer slots exists; a pair
    takes the whole warp; the table fits a block.  A plan= override is
    refused when the kernel is not built for it, when it would leave lanes
    beyond the needle, or when its table passes a block's shared memory;
    the main path's needle takes a map with no idle lane, at 32 lanes when
    it runs as one segment."""
    for rows in (5, 257):
        fits = [w for w in mc.WPT_CHOICES
                if mc._smem_bytes(rows, w) <= mc.SMEM_BYTES]
        for m in range(1, 4201):
            nw = -(-m // 32)
            for search in (False, True):
                pl = mc.blocked_plan(m, rows, search=search)
                w, g, ns = pl["words_per_lane"], pl["lanes"], pl["strips"]
                assert w in fits and g in mc.LANE_CHOICES
                slots = {(x // (g * w), x % (g * w) // w, x % w)
                         for x in range(nw)}
                assert len(slots) == nw and ns == -(-nw // (g * w))
                assert all(st < ns and ln < g for st, ln, _ in slots)
                if not search:
                    assert g == 32 and pl["warps"] == 1
                elif ns == 1:
                    assert g == 4 or (g // 2) * w < nw
                    assert g * w == min(
                        x * y for x in mc.LANE_CHOICES for y in fits
                        if x * y >= nw and (x == 4 or (x // 2) * y < nw))
                    assert 1 <= pl["warps"] <= mc.MAX_WARPS
    main = mc.blocked_plan(3000, 5, search=True)
    assert main["lanes"] * main["words_per_lane"] == 96  # 94 words
    assert -(-94 // main["words_per_lane"]) == main["lanes"]
    # a lone segment (the anchored search) is latency-bound: most lanes
    lone = mc.blocked_plan(3000, 5, search=True, segments=1)
    assert (lone["lanes"], lone["words_per_lane"], lone["warps"]) == (32, 3, 1)
    ok = {"words_per_lane": 3, "lanes": 32, "warps": 2}
    assert mc.blocked_plan(3000, 5, search=True, plan=ok)["strips"] == 1
    for bad in ({"words_per_lane": 5, "lanes": 32, "warps": 1},
                {"words_per_lane": 3, "lanes": 64, "warps": 1},
                {"words_per_lane": 3, "lanes": 32, "warps": 9},
                {"words_per_lane": 20, "lanes": 32, "warps": 1}):
        with pytest.raises(ValueError, match="does not take"):
            mc.blocked_plan(3000, 5, search=True, plan=bad)
    with pytest.raises(ValueError, match="does not take"):  # 257 x 8 words
        mc.blocked_plan(3000, 257, search=True,
                        plan={"words_per_lane": 8, "lanes": 16, "warps": 1})
    with pytest.raises(ValueError, match="does not take"):  # a pair: a warp
        mc.blocked_plan(3000, 5, plan={"words_per_lane": 12, "lanes": 8,
                                       "warps": 1})

