"""K3 / K4's wide regime (bands of 545 - 9,291 cells), on the CPU.

Past 544 cells the band kernel runs its block regime: one pair a block of
warps, the warp regime's lanes joined across warps (`band_block_kernel`,
plan regime "wide", engines `band` / `band_trace`).  Held here: the plan's
map of the regime (cells a lane, warps a pair, the bands it takes) and the
refusals of a forced plan; `levenshtein_k_batch` at k = 257, 300 and 1,000
and `levenshtein()` / `rdamerau()` on a 300-byte pair, untraced and traced,
against the JAX package's functions and the scalar oracle, with the
dispatch log and the plan of each call.  On the CPU the wrappers take the
plain version; the kernel's own body is held against it in
`test_torch_host_rehearsal.py`.  Tolerance: exact.
"""

import importlib

import numpy as np
import pytest
import torch

from triple_accel_tpu.types import EditCosts as JEditCosts

from triple_accel_tpu_torch.dispatch import last_dispatch
from triple_accel_tpu_torch.ops import lev_band as tlb
from triple_accel_tpu_torch.types import EditCosts

from test_torch_band_trace import _fields, _oracle, _replay_cost

# one intra-op thread: the test workers run side by side on the
# machine's cores
torch.set_num_threads(1)

jl = importlib.import_module("triple_accel_tpu.levenshtein")
tl = importlib.import_module("triple_accel_tpu_torch.levenshtein")

U32_MAX = (1 << 32) - 1
UNIT, RDAMERAU = (1, 1, 0, None), (1, 1, 0, 1)
WIDE_BANDS = (545, 1025, 2017, 2049, 4097, 8193, 9281, tlb.MAX_WIDE_BAND)


def _edited(rng, n_pairs, length, share, swaps):
    """ACGT strings and copies with `share` of their length in edits
    (substitutions, insertions and deletions) and `swaps` adjacent swaps;
    NUL bytes in the second a."""
    a_list, b_list = [], []
    for p in range(n_pairs):
        a = rng.choice(np.frombuffer(b"ACGT", np.uint8), length)
        if p == 1:
            a[rng.integers(0, length, 3)] = 0
        b = a.copy()
        n = int(length * share)
        b[rng.integers(0, length, n // 3)] = ord("T")
        b = np.delete(b, rng.integers(0, len(b), n // 3))
        b = np.insert(b, rng.integers(0, len(b) + 1, n - n // 3 - n // 3),
                      ord("G"))
        for q in rng.integers(0, len(b) - 1, swaps).tolist():
            b[q], b[q + 1] = b[q + 1], b[q]
        a_list.append(a)
        b_list.append(b)
    return a_list, b_list


def test_plan_maps_the_wide_bands_onto_one_block_of_warps():
    for W in WIDE_BANDS:
        unit_k = (W - 1) // 2
        nine = -(-W // (32 * 9))  # warps of 9 cells a lane that hold W
        for trace in (False, True):
            for batch, most in ((None, tlb.NINE_CELL_WARPS[0]),
                                (4096, tlb.NINE_CELL_WARPS[0]),
                                (1, tlb.NINE_CELL_WARPS[1]),
                                (tlb.SM_COUNT - 1, tlb.NINE_CELL_WARPS[1])):
                plan = tlb.band_plan(20_000, unit_k, trace, batch=batch)
                c, nw = plan["cells_per_lane"], plan["warps_per_pair"]
                assert plan["regime"] == "wide"
                assert c == (9 if nine <= most else 17)
                assert 32 * c * (nw - 1) < W <= 32 * c * nw
                assert nw <= tlb.BLOCK_MAX_WARPS[c]
                assert plan["threads"] == plan["lanes_per_pair"] == 32 * nw
                assert plan["pairs_per_block"] == 1
                assert plan["smem_bytes"] < 1024
                assert plan["scratch_bytes_per_pair"] == 0
                tlb._check_plan(plan, W)
    # the sweep's choices: 9 cells a lane at 545 cells, 17 past it; a
    # batch that leaves SMs empty 9 up to 8 warps of them
    assert tlb._block_map(545, None) == (9, 2)
    assert tlb._block_map(1025, None) == (17, 2)
    assert tlb._block_map(2049, 1) == (9, 8)
    assert tlb._block_map(4097, 1) == (17, 8)


def test_the_regime_takes_exactly_the_bands_the_shared_memory_body_took():
    # the widest band whose state (6 rows of W ints, an int a warp, a code
    # byte a cell) fitted a block's shared memory, and its power of two
    def state_bytes(W):
        return (6 * W + 32) * 4 + ((W + 3) & ~3)

    assert tlb.MAX_WIDE_BAND == 9291 and tlb.MAX_UNIT_K == 4096
    assert state_bytes(tlb.MAX_WIDE_BAND) <= tlb.SMEM_BYTES_PER_BLOCK
    assert state_bytes(tlb.MAX_WIDE_BAND + 2) > tlb.SMEM_BYTES_PER_BLOCK
    assert state_bytes(2 * tlb.MAX_UNIT_K + 1) <= tlb.SMEM_BYTES_PER_BLOCK
    assert state_bytes(4 * tlb.MAX_UNIT_K + 1) > tlb.SMEM_BYTES_PER_BLOCK
    for trace in (False, True):
        # the first band past the warp regime's 544 cells, and the last
        # inside it
        assert tlb.band_plan(8, 272, trace)["regime"] == "wide"
        assert tlb.band_plan(8, 271, trace)["regime"] == "warp"
        assert tlb.band_plan(8, 4645, trace)["regime"] == "wide"
    # every untraced band up to MAX_UNIT_K, and none past the widest
    assert tlb.band_plan(8, tlb.MAX_UNIT_K)["regime"] == "wide"
    assert tlb.band_plan(8, 4646) is None
    # traced bands past it: the cluster regime, whatever the length of b
    # (its warps a ring over strips of the columns)
    assert tlb.band_plan(8, 4646, True)["regime"] == "wide_cluster"
    assert tlb.band_plan(8, 4640, True, max_n=90_000)["regime"] == "wide"
    assert tlb.band_plan(8, 4656, True, max_n=90_000)["regime"] \
        == "wide_cluster"


BAD_PLANS = [
    dict(cells_per_lane=5),  # not an instantiation
    dict(warps_per_pair=0, threads=0, lanes_per_pair=0),
    dict(cells_per_lane=9, warps_per_pair=17, threads=544,
         lanes_per_pair=544),  # past 9 cells' 16 warps
    dict(cells_per_lane=17, warps_per_pair=19, threads=608,
         lanes_per_pair=608),  # past 17 cells' 18 warps
    dict(threads=96),  # not 32 a warp of the plan's warps
    dict(cells_per_lane=9, warps_per_pair=1, threads=32,
         lanes_per_pair=32),  # 288 cells < W = 1025
]


@pytest.mark.parametrize("bad", BAD_PLANS,
                         ids=["cells5", "warps0", "warps17x9", "warps19x17",
                              "threads", "short"])
def test_a_forced_plan_the_kernel_does_not_take_raises(bad):
    unit_k = 512
    plan = dict(tlb.band_plan(16, unit_k), **bad)
    t = tlb.prepare_band_tensors([np.zeros(4, np.uint8)],
                                 [np.zeros(6, np.uint8)], unit_k, 16,
                                 device="cpu")
    with pytest.raises(ValueError, match="does not take the plan"):
        tlb.band_distance(*t, unit_k=unit_k, costs_t=(1, 1, 0, 0, False),
                          plan=plan)
    with pytest.raises(ValueError, match="does not take the plan"):
        tlb.band_trace(*t, unit_k=unit_k, costs_t=(1, 1, 0, 1, True),
                       plan=plan)


# (k, costs, string length, edit share): k = 257 is the first threshold
# past the warp regime (the untraced engines' band 1,025), 1,000 a band of
# 2,049 (traced: the 16-rounding of the longest b)
K_CASES = [(257, UNIT, 300, 0.2), (300, RDAMERAU, 330, 0.2),
           (1000, RDAMERAU, 560, 0.15)]


@pytest.mark.parametrize("trace", [False, True], ids=["untraced", "traced"])
@pytest.mark.parametrize("k,c,length,share", K_CASES,
                         ids=[f"k{k}" for k, *_ in K_CASES])
def test_wide_batches_equal_jax_and_oracle(k, c, length, share, trace):
    rng = np.random.default_rng(k + length)
    a_list, b_list = _edited(rng, 2, length, share, 4)
    got = tl.levenshtein_k_batch(a_list, b_list, k, EditCosts(*c), trace,
                                 device="cpu")
    d = last_dispatch()
    assert d.path == ("band_trace" if trace else "band")
    plan = tlb.band_plan(d.padded_m, d.unit_k, trace, batch=2,
                         max_n=max(len(b) for b in b_list))
    assert plan["regime"] == "wide" and 2 * d.unit_k + 1 > 544
    ref = jl.levenshtein_k_batch(a_list, b_list, k, JEditCosts(*c), trace)
    dists, traces = got if trace else (got, None)
    d_ref = ref[0] if trace else ref
    assert dists.tolist() == np.asarray(d_ref).tolist()
    for p, (a, b) in enumerate(zip(a_list, b_list)):
        exp_d, exp_tr = _oracle(a, b, k, c)
        assert int(dists[p]) == exp_d >= 0
        if trace:
            assert _fields(traces[p]) == _fields(ref[1][p]) == exp_tr
            assert _replay_cost(a, b, exp_tr, c) == exp_d


@pytest.mark.parametrize("c", [UNIT, RDAMERAU], ids=["levenshtein",
                                                       "rdamerau"])
def test_front_door_on_a_300_byte_pair_equals_jax_and_oracle(c):
    rng = np.random.default_rng(300 + (c[3] or 0))
    (a,), (b,) = _edited(rng, 1, 300, 0.1, 3)
    fn = "levenshtein" if c == UNIT else "rdamerau"
    got = getattr(tl, fn)(a, b, device="cpu")
    d = last_dispatch()
    assert d.path == "band" and d.unit_k == 512
    assert tlb.band_plan(d.padded_m, d.unit_k, batch=1)["regime"] == "wide"
    assert got == getattr(jl, fn)(a, b) == _oracle(a, b, U32_MAX, c)[0]
    traced = tl.levenshtein_simd_k_with_opts(a, b, U32_MAX, True,
                                             EditCosts(*c), device="cpu")
    assert last_dispatch().path == "band_trace"
    ref = jl.levenshtein_simd_k_with_opts(a, b, U32_MAX, True,
                                          JEditCosts(*c))
    assert traced[0] == ref[0] == got
    assert _fields(traced[1]) == _fields(ref[1])
    assert _replay_cost(a, b, _fields(traced[1]), c) == got
