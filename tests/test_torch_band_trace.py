"""Batched tracebacks of the PyTorch/CUDA port, on the CPU.

Module level: the same numpy arrays go through the JAX package's
`band_trace_batch` and `band_trace_pallas` (interpret mode) +
`walk_packed_traceback`, and through the port's `band_trace_batch` and
`band_trace` (plain version: CPU tensors) + `walk_packed_traceback`; the
walked streams and the decoded `Edit` lists must be equal field by field
(each package has its own `Edit` type).  Slice level: `levenshtein_k_batch`
with `trace_on=True` and the single-pair wrappers against the JAX functions
and the scalar oracle, tie-breaks included.  Tolerance: exact.
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

from test_torch_band_distance import COSTS, COST_IDS, _ct, _pairs

# one intra-op thread: the test workers run side by side on the
# machine's cores
torch.set_num_threads(1)

jl = importlib.import_module("triple_accel_tpu.levenshtein")
tl = importlib.import_module("triple_accel_tpu_torch.levenshtein")

CPU = dict(device="cpu")
UK, MAX_M = 8, 64


def _fields(edits):
    return None if edits is None else [(e.edit.name, e.count) for e in edits]


def _oracle(a, b, k, c):
    ref = levenshtein_naive_k_with_opts(a, b, k, True, JEditCosts(*c))
    return (-1, None) if ref is None else (ref[0], _fields(ref[1]))


def _replay_cost(a, b, edits, c):
    """Apply an edit list to a, check it spells b, and price it."""
    mc, gc, sgc, tc, _ = _ct(c)
    i = j = cost = 0
    for name, cnt in edits:
        if name == "Match":
            assert (a[i:i + cnt] == b[j:j + cnt]).all()
            i, j = i + cnt, j + cnt
        elif name == "Mismatch":
            assert (a[i:i + cnt] != b[j:j + cnt]).all()
            i, j, cost = i + cnt, j + cnt, cost + cnt * mc
        elif name == "AGap":  # a gap in a: consumes b
            j, cost = j + cnt, cost + sgc + cnt * gc
        elif name == "BGap":
            i, cost = i + cnt, cost + sgc + cnt * gc
        else:
            for _ in range(cnt):
                assert a[i] == b[j + 1] and a[i + 1] == b[j]
                i, j, cost = i + 2, j + 2, cost + tc
    assert i == len(a) and j == len(b)
    return cost


# ---------------------------------------------------------------------------
# module level
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("c", COSTS, ids=COST_IDS)
def test_band_trace_batch_equals_jax(c):
    rng = np.random.default_rng(500 + c[0] + 7 * c[2])
    a_list, b_list = _pairs(rng, 40, 60, UK)
    arrs = jbs.prepare_band_inputs(a_list, b_list, UK, MAX_M)
    d_ref, seq_ref, steps_ref = jbs.band_trace_batch(
        *arrs, unit_k=UK, max_m=MAX_M, costs_t=_ct(c))
    d, seq, steps = tbs.band_trace_batch(
        *[torch.from_numpy(x) for x in arrs], unit_k=UK, costs_t=_ct(c))
    assert steps == steps_ref == 2 * MAX_M + UK + 1
    assert d.tolist() == np.asarray(d_ref).tolist()
    assert seq.dtype == torch.int8
    assert np.array_equal(seq.numpy(), np.asarray(seq_ref))
    swaps = [bool(p % 2) for p in range(len(a_list))]
    got = tbs.decode_walked_batch(*tbs.run_length_encode(seq), swaps)
    ref = jbs.decode_walked_batch(np.asarray(seq_ref), swaps)
    assert [_fields(t) for t in got] == [_fields(t) for t in ref]


@pytest.mark.parametrize("c", [COSTS[1], COSTS[3]],
                         ids=[COST_IDS[1], COST_IDS[3]])
def test_band_trace_equals_jax_pallas_interpret(c):
    rng = np.random.default_rng(600 + c[0])
    a_list, b_list = _pairs(rng, 30, 60, UK)
    B = len(a_list)
    ref_in = jlb.prepare_pallas_inputs(a_list, b_list, UK, MAX_M)
    d_ref, codes_ref = jlb.band_trace_pallas(
        *ref_in, unit_k=UK, max_m=MAX_M, costs_t=_ct(c), interpret=True)
    seq_ref, _ = jbs.walk_packed_traceback(
        codes_ref, *ref_in[:4], unit_k=UK, max_m=MAX_M,
        P8=jlb.packed_code_rows(2 * UK + 1))
    t = tlb.from_reference_batch(*ref_in, unit_k=UK, max_m=MAX_M, **CPU)
    before = tlb.band_trace.launches
    d, codes = tlb.band_trace(*t, unit_k=UK, costs_t=_ct(c))
    assert tlb.band_trace.launches == before  # CPU tensors: plain version
    assert codes.dtype == torch.int32
    assert codes.shape == (t[0].shape[0], MAX_M, tbs.code_words(2 * UK + 1))
    seq, _ = tbs.walk_packed_traceback(codes, *t, unit_k=UK)
    assert d[:B].tolist() == np.asarray(d_ref)[0, :B].tolist()
    assert np.array_equal(seq.numpy()[:B], np.asarray(seq_ref)[:B])
    swaps = [False] * B
    assert [_fields(x) for x in tbs.decode_walked_batch(
        *tbs.run_length_encode(seq[:B]), swaps)] \
        == [_fields(x) for x in
            jbs.decode_walked_batch(np.asarray(seq_ref)[:B], swaps)]


@pytest.mark.parametrize("c", COSTS, ids=COST_IDS)
def test_batched_walk_equals_host_decode_and_oracle(c):
    rng = np.random.default_rng(700 + c[0])
    a_list, b_list = _pairs(rng, 40, 40, UK)
    t = tlb.prepare_band_tensors(a_list, b_list, UK, 48, **CPU)
    d, codes = tlb.band_trace(*t, unit_k=UK, costs_t=_ct(c))
    seq, _ = tbs.walk_packed_traceback(codes, *t, unit_k=UK)
    swaps = [bool(p % 3 == 0) for p in range(len(a_list))]
    walked = tbs.decode_walked_batch(*tbs.run_length_encode(seq), swaps)
    cells = tbs.unpack_codes(codes, 2 * UK + 1).numpy()
    assert cells.shape == (len(a_list), 48, 2 * UK + 1) and cells.max() <= 3
    kband = UK * c[1] + c[2]
    for p, (a, b) in enumerate(zip(a_list, b_list)):
        host = tbs.decode_traceback(cells[p], a, b, UK, swaps[p])
        assert _fields(walked[p]) == _fields(host)
        exp_d, exp_tr = _oracle(a, b, kband, c)
        if exp_d >= 0 and not swaps[p]:
            assert int(d[p]) == exp_d and _fields(walked[p]) == exp_tr
        if not swaps[p]:
            # the script always spells b; its price is the distance when
            # gaps have no start cost (a one-matrix affine traceback may
            # re-open a gap the DP had extended)
            cost = _replay_cost(a, b, _fields(walked[p]), c)
            assert cost == int(d[p]) if c[2] == 0 else cost >= int(d[p])


def test_decode_walked_batch_equals_jax_on_random_streams():
    rng = np.random.default_rng(8)
    seq = np.full((30, 40), -1, np.int8)
    for p in range(30):
        ln = int(rng.integers(0, 41))
        seq[p, :ln] = rng.integers(0, 5, ln)
    swaps = [bool(x) for x in rng.integers(0, 2, 30)]
    assert [_fields(t) for t in tbs.decode_walked_batch(
        *tbs.run_length_encode(torch.from_numpy(seq)), swaps)] == \
        [_fields(t) for t in jbs.decode_walked_batch(seq, swaps)]


def test_pads_equal_to_real_characters_change_nothing():
    """The buffers pad with 0 and strings may hold NUL: filling every pad
    with a byte of the alphabet must give the same distances."""
    rng = np.random.default_rng(9)
    a_list, b_list = _pairs(rng, 40, 40, UK, alphabet=(0, 3))
    a_t, b_t, m, n = tlb.prepare_band_tensors(a_list, b_list, UK, 48, **CPU)
    a2, b2 = a_t.clone(), b_t.clone()
    for p in range(len(a_list)):
        a2[p, int(m[p]):] = 1
        b2[p, :UK] = 1
        b2[p, UK + int(n[p]):] = 1
    for c in COSTS:
        d1, c1 = tlb.band_trace(a_t, b_t, m, n, unit_k=UK, costs_t=_ct(c))
        d2, c2 = tlb.band_trace(a2, b2, m, n, unit_k=UK, costs_t=_ct(c))
        assert torch.equal(d1, d2)
        s1, _ = tbs.walk_packed_traceback(c1, a_t, b_t, m, n, unit_k=UK)
        s2, _ = tbs.walk_packed_traceback(c2, a2, b2, m, n, unit_k=UK)
        assert torch.equal(s1, s2)
        for p, (a, b) in enumerate(zip(a_list, b_list)):
            assert int(d1[p]) == _oracle(a, b, UK * c[1] + c[2], c)[0] or \
                int(d1[p]) > UK * c[1] + c[2]


@pytest.mark.parametrize("W", [1, 9, 16, 17, 65, 129])
def test_pack_and_unpack_codes_round_trip(W):
    rng = np.random.default_rng(W)
    code = torch.from_numpy(rng.integers(0, 4, (5, W)).astype(np.uint8))
    code[0] = 3  # the top slot of a word then sets the sign bit
    words = tbs.pack_codes(code)
    assert words.dtype == torch.int32 and words.shape == (5, -(-W // 16))
    assert torch.equal(tbs.unpack_codes(words, W), code)
    # the unsigned bit pattern: cell c at bits 2 * (c % 16) of word c // 16
    u = words.numpy().view(np.uint32)
    for c in range(W):
        assert ((u[:, c // 16] >> (2 * (c % 16))) & 3).tolist() == \
            code[:, c].tolist()


# ---------------------------------------------------------------------------
# slice level
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("c", COSTS, ids=COST_IDS)
def test_k_batch_traced_equals_jax_and_oracle(c):
    rng = np.random.default_rng(800 + c[0])
    a_list, b_list = _pairs(rng, 50, 40)  # unordered: swaps happen inside
    a_list[5], b_list[5] = a_list[5][:3], np.concatenate([b_list[5]] * 4)[:40]
    a_list[6] = np.empty(0, np.uint8)
    k = 6
    dists, traces = tl.levenshtein_k_batch(a_list, b_list, k, EditCosts(*c),
                                           True, **CPU)
    assert last_dispatch().path == "band_trace"
    d_ref, tr_ref = jl.levenshtein_k_batch(a_list, b_list, k, JEditCosts(*c),
                                           True)
    assert dists.dtype == np.int64
    assert dists.tolist() == np.asarray(d_ref).tolist()
    assert [_fields(t) for t in traces] == [_fields(t) for t in tr_ref]
    for p, (a, b) in enumerate(zip(a_list, b_list)):
        exp_d, exp_tr = _oracle(a, b, k, c)
        assert int(dists[p]) == exp_d and _fields(traces[p]) == exp_tr
        if exp_d >= 0 and c[2] == 0:
            assert _replay_cost(a, b, exp_tr, c) == exp_d
    assert (dists == -1).any() and traces[0] == []


def test_k_batch_traced_bucketed_and_chunked_equals_oracle(monkeypatch):
    rng = np.random.default_rng(43)
    a_list, b_list = [], []
    for lo, hi in ((0, 6), (40, 60)):  # two buckets, each past _MIN_BUCKET
        x, y = _pairs(rng, 280, hi, min_len=lo)
        a_list += x
        b_list += y
    c = COSTS[1]
    # a cap of a few pairs' codes: every bucket runs as many chunks
    monkeypatch.setattr(tl, "_TRACE_CODE_BYTES_CAP", 64 * 2 * 4 * 50)
    dispatch_history(clear=True)
    dists, traces = tl.levenshtein_k_batch(a_list, b_list, 4, EditCosts(*c),
                                           True, **CPU)
    launches = [d for _, d in dispatch_history()]
    assert len(launches) > 1 and {d.path for d in launches} == {"band_trace"}
    assert len(traces) == len(a_list)
    for p, (a, b) in enumerate(zip(a_list, b_list)):
        exp_d, exp_tr = _oracle(a, b, 4, c)
        assert int(dists[p]) == exp_d and _fields(traces[p]) == exp_tr


def test_k_batch_traced_empty_batch_and_mesh():
    from triple_accel_tpu_torch.parallel import make_mesh

    dists, traces = tl.levenshtein_k_batch([], [], 3, trace_on=True, **CPU)
    assert dists.shape == (0,) and traces == []
    # a traced batch on a mesh runs on the mesh's first device, as the JAX
    # package's does, and says so in the log
    mesh = make_mesh(["cpu"] * 4)
    dispatch_history(clear=True)
    d_m, tr_m = tl.levenshtein_k_batch([b"ab", b"kitten"], [b"ba", b"sit"],
                                       4, trace_on=True, mesh=mesh, **CPU)
    assert [d.path for _, d in dispatch_history()] == [
        "trace_mesh_ignored", "band_trace"]
    d_1, tr_1 = tl.levenshtein_k_batch([b"ab", b"kitten"], [b"ba", b"sit"],
                                       4, trace_on=True, **CPU)
    assert d_m.tolist() == d_1.tolist() == [2, 4] and tr_m == tr_1


@pytest.mark.parametrize("a,b", [
    (b"ab", b"ba"), (b"", b"abc"), (b"abc", b""), (b"kitten", b"sitting"),
    (b"sitting", b"kitten"), (b"a\x00bc", b"ab\x00c"),
    (b"the quick brown fox", b"teh qiuck brwon fxo jumps"),
])
def test_single_pair_trace_equals_jax_and_oracle(a, b):
    for c in COSTS:
        for k in (1, 5, 60):
            got = tl.levenshtein_simd_k_with_opts(a, b, k, True,
                                                  EditCosts(*c), **CPU)
            ref = jl.levenshtein_simd_k_with_opts(a, b, k, True,
                                                  JEditCosts(*c))
            exp_d, exp_tr = _oracle(a, b, k, c)
            if exp_d < 0:
                assert got is None and ref is None
                continue
            assert got[0] == ref[0] == exp_d
            assert _fields(got[1]) == _fields(ref[1]) == exp_tr
    got = tl.levenshtein_exp_with_opts(a, b, True, EditCosts(*COSTS[3]),
                                       **CPU)
    ref = jl.levenshtein_exp_with_opts(a, b, True, JEditCosts(*COSTS[3]))
    assert got[0] == ref[0] and _fields(got[1]) == _fields(ref[1])
    assert tl.levenshtein_simd_k_with_opts(b"", b"", 3, True, **CPU) == (0, [])


# batches past the plan have engines: untraced, the blocked Myers distance
# kernel for unit and rDamerau costs (test_torch_blocked_distance.py) and
# the flat distance kernel for the others (test_torch_flat_distance.py);
# traced, the band kernel's cluster regime and the walk
@pytest.mark.parametrize("c,trace,engine", [
    (COSTS[0], True, "band_trace_global"),
    (COSTS[1], True, "band_trace_global"),
    (COSTS[2], False, "flat_distance"),
    (COSTS[3], True, "band_trace_global"),
], ids=["unit", "rdamerau", "affine", "traced"])
def test_batches_past_the_band_plan_raise(c, trace, engine):
    """Every case here raised until its engine was ported (the untraced
    `affine` one until the flat distance kernel, the traced ones until the
    band kernel's device-memory regime and the walk K10); each now takes
    its engine on the shortest strings past the plan and is held against
    the compiled scalar comparator, traces replayed.  A traced batch runs
    at its unit_k rounded up to 16, so its strings are longer than the
    untraced one's: n = 4,704 gives band 9,409, past the block regime
    (`lev_band.MAX_WIDE_BAND`: n >= 4,641)."""
    from triple_accel_tpu_torch.utils.native import (
        scalar_banded_batch_native)

    k = (1 << 32) - 1  # unbounded: the band is the length
    if not trace:
        a = np.full(4150, 65, np.uint8)
        b = np.full(4150, 66, np.uint8)
        got = tl.levenshtein_k_batch([a], [b], k, EditCosts(*c), **CPU)
        assert last_dispatch().path == engine
        assert got.tolist() == scalar_banded_batch_native(
            [a], [b], k, EditCosts(*c)).tolist()
        return
    rng = np.random.default_rng(4100 + c[0])
    a = rng.integers(65, 69, 4700).astype(np.uint8)
    b = np.delete(a, rng.integers(0, 4700, 8))
    b[rng.integers(0, len(b), 20)] = 66
    b = np.insert(b, rng.integers(0, len(b), 12), 67)  # n = 4,704
    for q in rng.integers(0, len(b) - 1, 6).tolist():
        b[q], b[q + 1] = b[q + 1], b[q]
    got, traces = tl.levenshtein_k_batch([b], [a], k, EditCosts(*c), trace,
                                         **CPU)
    assert last_dispatch().path == engine and last_dispatch().unit_k == 4704
    assert got.tolist() == scalar_banded_batch_native(
        [b], [a], k, EditCosts(*c)).tolist()
    cost = _replay_cost(b, a, _fields(traces[0]), c)
    assert cost == int(got[0]) if c[2] == 0 else cost >= int(got[0])
