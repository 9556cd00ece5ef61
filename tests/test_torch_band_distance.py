"""The general-cost banded distance of the PyTorch/CUDA port, on the CPU.

Module level: the same numpy arrays go through the JAX package's
`band_scan_distance` and `band_distance_pallas` (interpret mode, as the JAX
package's own tests run it) and through the port's `band_scan_distance` and
`band_distance` (its plain version: the tensors lie on the CPU).  Slice
level: `levenshtein_k_batch` and the wrappers above it, any cost model,
against the JAX functions and the scalar oracle.  Tolerance: exact
(integers).  A handful of static shapes is reused, because the JAX side
recompiles for every (unit_k, max_m, costs).
"""

import importlib

import numpy as np
import pytest
import torch

from triple_accel_tpu.ops import band_scan as jbs
from triple_accel_tpu.ops.pallas import lev_band as jlb
from triple_accel_tpu.oracle import levenshtein_naive_k_with_opts
from triple_accel_tpu.types import EditCosts as JEditCosts

from triple_accel_tpu_torch.dispatch import dispatch_history, last_dispatch
from triple_accel_tpu_torch.ops import band_scan as tbs
from triple_accel_tpu_torch.ops import lev_band as tlb
from triple_accel_tpu_torch.types import EditCosts

jl = importlib.import_module("triple_accel_tpu.levenshtein")
tl = importlib.import_module("triple_accel_tpu_torch.levenshtein")

CPU = dict(device="cpu")
COSTS = [(1, 1, 0, None), (1, 1, 0, 1), (2, 1, 2, None), (3, 2, 1, 2)]
COST_IDS = ["unit", "rdamerau", "affine_2_1_2", "affine_transpose_3_2_1_2"]
UK, MAX_M = 8, 64  # the one static shape of the module-level tests
INF = 1 << 30


def _ct(c):
    return (c[0], c[1], c[2], c[3] or 0, c[3] is not None)


def _pairs(rng, n_pairs, max_len, unit_k=None, alphabet=(65, 70), min_len=0):
    """Edited copies with substitutions, insertions, deletions and adjacent
    swaps; NUL bytes in every fourth pair; the first pair empty.  With
    `unit_k`, pairs are ordered len(a) <= len(b) and kept inside the band."""
    a_list, b_list = [], []
    while len(a_list) < n_pairs:
        ln = int(rng.integers(min_len, max_len + 1))
        a = rng.integers(*alphabet, ln).astype(np.uint8)
        if ln and len(a_list) % 4 == 1:
            a[rng.integers(0, ln, 2)] = 0  # NUL chars: pads are 0 too
        b = list(a)
        for _ in range(int(rng.integers(0, 7))):
            op = rng.integers(0, 4)
            if op == 0 and b:
                b[rng.integers(0, len(b))] = rng.integers(*alphabet)
            elif op == 1:
                b.insert(int(rng.integers(0, len(b) + 1)),
                         int(rng.integers(*alphabet)))
            elif op == 2 and b:
                del b[rng.integers(0, len(b))]
            elif op == 3 and len(b) > 1:
                q = int(rng.integers(0, len(b) - 1))
                b[q], b[q + 1] = b[q + 1], b[q]
        b = np.array(b, dtype=np.uint8)
        if unit_k is not None:
            if len(a) > len(b):
                a, b = b, a
            if len(b) - len(a) > unit_k or len(a) > max_len:
                continue
        a_list.append(a)
        b_list.append(b)
    a_list[0] = b_list[0] = np.empty(0, np.uint8)
    return a_list, b_list


def _oracle(a, b, k, c):
    ref = levenshtein_naive_k_with_opts(a, b, k, False, JEditCosts(*c))
    return -1 if ref is None else ref[0]


# ---------------------------------------------------------------------------
# module level
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("c", COSTS, ids=COST_IDS)
def test_band_scan_distance_equals_jax_band_scan(c):
    rng = np.random.default_rng(100 + c[0] + 7 * c[2])
    a_list, b_list = _pairs(rng, 48, 60, UK)
    # pairs at the band's edge: n - m == unit_k, and m == 0 against n > 0
    a_list[1], b_list[1] = a_list[2][:5], np.concatenate(
        [a_list[2][:5], rng.integers(65, 70, UK).astype(np.uint8)])
    a_list[3], b_list[3] = np.empty(0, np.uint8), b_list[4][:UK]
    arrs = jbs.prepare_band_inputs(a_list, b_list, UK, MAX_M)
    ref, _ = jbs.band_scan_distance(*arrs, unit_k=UK, max_m=MAX_M,
                                    costs_t=_ct(c), trace_on=False)
    own = tbs.prepare_band_inputs(a_list, b_list, UK, MAX_M)
    assert all(np.array_equal(x, y) for x, y in zip(arrs, own))
    got, codes = tbs.band_scan_distance(
        *[torch.from_numpy(x) for x in own], unit_k=UK, costs_t=_ct(c),
        trace_on=False)
    assert codes is None and got.dtype == torch.int32
    assert got.tolist() == np.asarray(ref).tolist()
    kband = UK * c[1] + c[2]  # every cost <= this stays inside the band
    for p, (a, b) in enumerate(zip(a_list, b_list)):
        exp = _oracle(a, b, 10**9, c)
        assert int(got[p]) == exp if exp <= kband else int(got[p]) >= exp


@pytest.mark.parametrize("c", COSTS, ids=COST_IDS)
def test_band_distance_equals_jax_pallas_interpret(c):
    rng = np.random.default_rng(200 + c[0] + 7 * c[2])
    a_list, b_list = _pairs(rng, 40, 60, UK)
    ref_in = jlb.prepare_pallas_inputs(a_list, b_list, UK, MAX_M)
    ref = np.asarray(jlb.band_distance_pallas(
        *ref_in, unit_k=UK, max_m=MAX_M, costs_t=_ct(c), interpret=True))[0]
    t = tlb.from_reference_batch(*ref_in, unit_k=UK, max_m=MAX_M, **CPU)
    before = tlb.band_distance.launches
    got = tlb.band_distance(*t, unit_k=UK, costs_t=_ct(c))
    assert tlb.band_distance.launches == before  # CPU tensors: plain version
    B = len(a_list)  # past B the reference's batch pads answer INF
    assert got.shape == (ref.size,) and got[:B].tolist() == ref[:B].tolist()
    assert (ref[B:] >= INF).all() and (got[B:] == 0).all()
    # the port's own prep gives the same tensors for the real pairs
    own = tlb.prepare_band_tensors(a_list, b_list, UK, MAX_M, **CPU)
    for x, y in zip(own, t):
        assert torch.equal(x, y[: len(a_list)])


def test_from_reference_batch_takes_the_sentinel_layout():
    rng = np.random.default_rng(5)
    a_list, b_list = _pairs(rng, 20, 30, 4)
    a_r, b_r, m, n, c_fin = jlb.prepare_pallas_inputs(a_list, b_list, 4, 32)
    a_s, b_s = jlb._mask_band_inputs(a_r, b_r, m, n, 4)  # int32, transposed
    t_rows = tlb.from_reference_batch(a_r, b_r, m, n, c_fin, unit_k=4,
                                      max_m=32, **CPU)
    t_sent = tlb.from_reference_batch(np.asarray(a_s), np.asarray(b_s), m, n,
                                      c_fin, unit_k=4, max_m=32, **CPU)
    ct = (1, 1, 0, 1, True)
    assert torch.equal(tlb.band_distance(*t_rows, unit_k=4, costs_t=ct),
                       tlb.band_distance(*t_sent, unit_k=4, costs_t=ct))
    with pytest.raises(ValueError, match="c_fin"):
        tlb.from_reference_batch(a_r, b_r, m, n, c_fin + 1, unit_k=4,
                                 max_m=32, **CPU)


def test_wrapper_checks_its_inputs():
    a_list, b_list = [np.zeros(3, np.uint8)], [np.zeros(5, np.uint8)]
    with pytest.raises(ValueError, match="unit_k"):
        tlb.prepare_band_tensors(a_list, b_list, 1, 8, **CPU)  # gap 2 > 1
    with pytest.raises(ValueError, match="max_m"):
        tlb.prepare_band_tensors(a_list, b_list, 4, 2, **CPU)
    a_t, b_t, m, n = tlb.prepare_band_tensors(a_list, b_list, 4, 8, **CPU)
    ct = (1, 1, 0, 0, False)
    with pytest.raises(TypeError):
        tlb.band_distance(a_t.to(torch.int32), b_t, m, n, unit_k=4, costs_t=ct)
    with pytest.raises(ValueError, match="row lengths"):
        tlb.band_distance(a_t, b_t[:, :-1], m, n, unit_k=4, costs_t=ct)
    with pytest.raises(ValueError, match="int32"):
        tlb.band_distance(a_t, b_t, m.to(torch.int64), n, unit_k=4, costs_t=ct)
    with pytest.raises(ValueError, match="band plan"):
        tlb.band_distance(a_t, b_t, m, n, unit_k=8192, costs_t=ct)
    with pytest.raises(ValueError, match="u8"):
        tlb.band_distance(a_t, b_t, m, n, unit_k=4,
                          costs_t=(300, 1, 0, 0, False))
    assert tlb.band_distance(a_t, b_t, m, n, unit_k=4, costs_t=ct).tolist() \
        == [2]


def test_select_band_dtype_equals_jax_over_a_grid():
    n = 0
    for c in COSTS + [(9, 7, 40, 12), (255, 255, 255, None)]:
        for unit_k in (0, 4, 8, 30, 64, 500, 4096):
            for max_k in (0, 5, 100, 126, 127, 1000, 32000, 40000, 10**6):
                assert tlb.select_band_dtype(max_k, unit_k, _ct(c)) == \
                    jlb.select_band_dtype(max_k, unit_k, _ct(c))
                n += 1
    assert n == 6 * 7 * 9
    assert tlb.select_band_dtype(5, 4, (1, 1, 0, 0, False))[0] == "int8"
    assert tlb.select_band_dtype(10**6, 4, (1, 1, 0, 0, False)) == \
        ("int32", INF)


@pytest.mark.parametrize("unit_k", [4, 8, 32, 64, 256, 512, 2048, 4096])
def test_band_plan_fits_one_block(unit_k):
    W = 2 * unit_k + 1
    for trace in (False, True):
        plan = tlb.band_plan(1000, unit_k, trace)
        assert plan["threads"] % 32 == 0 and 32 <= plan["threads"] <= 1024
        assert plan["threads"] * plan["cells_per_thread"] >= W
        assert 6 * W * 4 < plan["smem_bytes"] <= tlb.SMEM_BYTES_PER_BLOCK
        assert plan["code_words"] == (tbs.code_words(W) if trace else 0)
        assert plan["code_bytes_per_pair"] == (
            1000 * tbs.code_words(W) * 4 if trace else 0)
    # string length does not bound the plan; the band does
    assert tlb.band_plan(10**7, unit_k) is not None
    assert tlb.band_plan(8, 2 * tlb.MAX_UNIT_K) is None
    assert tlb.MAX_UNIT_K == 4096


# ---------------------------------------------------------------------------
# slice level
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("c", COSTS[1:], ids=COST_IDS[1:])
def test_k_batch_any_costs_equals_jax_and_oracle(c):
    rng = np.random.default_rng(300 + c[0])
    a_list, b_list = _pairs(rng, 60, 50)  # unordered: swaps happen inside
    # an infeasible pair (length gap above the threshold) and an empty side
    a_list[5], b_list[5] = a_list[5][:3], np.concatenate([b_list[5]] * 3)[:40]
    a_list[6] = np.empty(0, np.uint8)
    k = 6
    got = tl.levenshtein_k_batch(a_list, b_list, k, EditCosts(*c), **CPU)
    assert last_dispatch().path == "band"
    ref = jl.levenshtein_k_batch(a_list, b_list, k, JEditCosts(*c))
    assert got.dtype == np.int64 and got.tolist() == np.asarray(ref).tolist()
    assert got.tolist() == [_oracle(a, b, k, c)
                            for a, b in zip(a_list, b_list)]
    assert (got == -1).any() and (got >= 0).any() and got[0] == 0


def test_k_batch_bucketed_rdamerau_equals_oracle():
    rng = np.random.default_rng(41)
    a_list, b_list = [], []
    for ln in (6, 100):  # pow2 length buckets, each past _MIN_BUCKET
        x, y = _pairs(rng, 300, ln)
        a_list += x
        b_list += y
    assert len(a_list) > tl._MIN_BUCKET
    c = COSTS[1]
    dispatch_history(clear=True)
    got = tl.levenshtein_k_batch(a_list, b_list, 5, EditCosts(*c), **CPU)
    launches = [d for _, d in dispatch_history()]
    assert len(launches) > 1 and {d.path for d in launches} == {"band"}
    assert got.tolist() == [_oracle(a, b, 5, c)
                            for a, b in zip(a_list, b_list)]


def test_forced_band_path_equals_the_myers_path(monkeypatch):
    rng = np.random.default_rng(17)
    a_list, b_list = _pairs(rng, 80, 90)
    ref = tl.levenshtein_k_batch(a_list, b_list, 9, **CPU)
    assert last_dispatch().path == "myers"
    monkeypatch.setenv("TRIPLE_ACCEL_TORCH_FORCE_PATH", "band")
    got = tl.levenshtein_k_batch(a_list, b_list, 9, **CPU)
    assert last_dispatch().path == "band"
    assert got.tolist() == ref.tolist()


def test_levenshtein_past_the_myers_plan_takes_the_band_kernel():
    rng = np.random.default_rng(23)
    a = rng.integers(65, 69, 230).astype(np.uint8)
    b = rng.integers(65, 69, 260).astype(np.uint8)
    got = tl.levenshtein(a, b, **CPU)
    d = last_dispatch()
    assert d.path == "band" and d.max_k > 191
    assert got == jl.levenshtein(a, b) == _oracle(a, b, 10**9, COSTS[0])
    assert tl.levenshtein(b"a" * 400, b"b" * 400, **CPU) == 400
    assert tl.levenshtein_exp(a, b, **CPU) == got


@pytest.mark.parametrize("a,b", [
    (b"abc", b"acb"), (b"", b"abc"), (b"abcd", b"abdc"), (b"ca", b"abc"),
    (b"kitten", b"sitting"), (b"a\x00bc", b"ab\x00c"),
    (b"the quick brown fox", b"teh qiuck brwon fxo jumps"),
])
def test_rdamerau_wrappers_equal_jax_and_oracle(a, b):
    exp = _oracle(a, b, 10**9, COSTS[1])
    assert tl.rdamerau(a, b, **CPU) == jl.rdamerau(a, b) == exp
    assert tl.rdamerau_exp(a, b, **CPU) == jl.rdamerau_exp(a, b) == exp
    c = COSTS[3]
    got = tl.levenshtein_exp_with_opts(a, b, False, EditCosts(*c), **CPU)
    assert got == jl.levenshtein_exp_with_opts(a, b, False, JEditCosts(*c))
    assert got == (_oracle(a, b, 10**9, c), None)
    for k in (0, 2, 40):
        got = tl.levenshtein_simd_k_with_opts(a, b, k, False, EditCosts(*c),
                                              **CPU)
        exp_k = _oracle(a, b, k, c)
        assert got == (None if exp_k < 0 else (exp_k, None))


@pytest.mark.parametrize("c", COSTS[1:], ids=COST_IDS[1:])
def test_exp_batch_any_costs_equals_jax_and_oracle(c):
    rng = np.random.default_rng(3 + c[0])
    a_list = [rng.integers(65, 69, int(rng.integers(0, 70))).astype(np.uint8)
              for _ in range(24)]
    b_list = [rng.integers(65, 69, int(rng.integers(0, 70))).astype(np.uint8)
              for _ in range(24)]
    got = tl.levenshtein_exp_batch(a_list, b_list, EditCosts(*c), **CPU)
    assert got.tolist() == [_oracle(a, b, 10**9, c)
                            for a, b in zip(a_list, b_list)]
    if c == COSTS[1]:  # one cost model through the JAX retry ladder too
        ref = jl.levenshtein_exp_batch(a_list, b_list, JEditCosts(*c))
        assert got.tolist() == np.asarray(ref).tolist()
