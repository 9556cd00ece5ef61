"""The traceback walk of the PyTorch/CUDA port (kernel K10's plain path)
and the traced route's decode, on the CPU.

Module level: the port's `trace_walk` on CPU tensors (its plain version,
`trace_walk_plain`: the walk, then a run-length encoding) against the
JAX package's `walk_packed_traceback` (the codes repacked into its Pallas
layout), its `band_trace_batch` (its own scan and walk), its
`decode_walked_batch` and the scalar `decode_traceback`, the runs expanded
back to steps, on numpy-seeded pairs with the walk's edges: m = 0 and
empty pairs, a transposition as the walk's last step, walks along band
cells 0, W - 1 and the edges of 16-code words, a batch that is not a
multiple of the kernel's block, the longest walk the bound allows, single
runs as long as a walk (one to the `steps` cap), and random codes, where
walks leave the matrix; the decode's shared `Edit` objects; the 2^28
limit of a run's count.  Slice level through `levenshtein_k_batch`: one
traced batch past the band plan, swapped and unswapped pairs in one
batch, pairs past the threshold (None), and a batch cut into chunks by a
small `_TRACE_CODE_BYTES_CAP`, field by field against the JAX package and
the oracle.  Also `chip_smoke.py`'s helpers of the walk's checks on the
card (edge pairs, walked cells, K10's bound).  Tolerance: exact.
"""

import importlib

import numpy as np
import pytest
import torch

import chip_smoke as cs
from triple_accel_tpu.ops import band_scan as jbs
from triple_accel_tpu.ops.pallas import lev_band as jlb
from triple_accel_tpu.types import EditCosts as JEditCosts

from triple_accel_tpu_torch.dispatch import last_dispatch
from triple_accel_tpu_torch.oracle import (
    levenshtein_naive_k_with_opts as _naive)
from triple_accel_tpu_torch.ops import band_scan as tbs
from triple_accel_tpu_torch.ops import lev_band as tlb
from triple_accel_tpu_torch.ops import trace_walk as ttw
from triple_accel_tpu_torch.types import EditCosts
from triple_accel_tpu_torch.utils import profiling as prof
from triple_accel_tpu_torch.types import LEVENSHTEIN_COSTS as _LEV
from triple_accel_tpu_torch.utils.native import scalar_banded_batch_native

from test_torch_band_distance import COSTS, COST_IDS, _ct, _pairs

# one intra-op thread: the test workers run side by side on the
# machine's cores
torch.set_num_threads(1)

jl = importlib.import_module("triple_accel_tpu.levenshtein")
tl = importlib.import_module("triple_accel_tpu_torch.levenshtein")

UK, MAX_M = 16, 80  # W = 33: three code words a row, cells 0 .. 32
BLOCK = 32  # threads a block of the kernel (csrc/trace_walk.cu)


def _fields(edits):
    return None if edits is None else [(e.edit.name, e.count) for e in edits]


def _expand(runs, counts, steps):
    """The runs of `trace_walk` back to the [B, steps] steps the JAX walks
    return (reverse walk order, -1 past each walk's end)."""
    B = counts.shape[0]
    seq = torch.full((B, steps), -1, dtype=torch.int8)
    r = runs.to(torch.int64)
    length = r >> 3
    pair = torch.repeat_interleave(torch.arange(B), counts.to(torch.int64))
    walked = torch.zeros(B, dtype=torch.int64).index_add_(0, pair, length)
    rows = torch.repeat_interleave(torch.arange(B), walked)
    first = torch.cumsum(walked, 0) - walked
    seq[rows, torch.arange(rows.numel()) - first[rows]] = \
        torch.repeat_interleave(r & 7, length).to(torch.int8)
    return seq


def _walk(codes, t, unit_k):
    """K10's plain path on CPU tensors: (runs, counts), and the runs
    expanded back to the [B, steps] steps the JAX walks return."""
    before = ttw.trace_walk.launches
    runs, counts = ttw.trace_walk(codes, *t, unit_k=unit_k)
    assert ttw.trace_walk.launches == before  # CPU tensors: plain version
    assert runs.dtype == counts.dtype == torch.int32
    steps = ttw.walk_steps(t[0].shape[1], unit_k)
    return runs, counts, _expand(runs, counts, steps)


def _jax_packed(codes: torch.Tensor, W: int) -> np.ndarray:
    """The port's codes [B, rows, ceil(W / 16)] in the JAX package's Pallas
    layout: [rows * P8, B], PACK cells a word."""
    cells = tbs.unpack_codes(codes, W).numpy().astype(np.int64)
    B, rows, _ = cells.shape
    P8 = jlb.packed_code_rows(W)
    out = np.zeros((rows, P8, B), np.int64)
    for c in range(W):
        out[:, c // jlb.PACK, :] |= cells[:, :, c].T << (2 * (c % jlb.PACK))
    out = np.where(out >= 1 << 31, out - (1 << 32), out)
    return out.reshape(rows * P8, B).astype(np.int32)


def _jax_walk(codes, t, unit_k):
    a_t, b_t, m, n = (x.numpy() for x in t)
    seq, steps = jbs.walk_packed_traceback(
        _jax_packed(codes, 2 * unit_k + 1), a_t, b_t, m[None, :],
        n[None, :], unit_k=unit_k, max_m=a_t.shape[1],
        P8=jlb.packed_code_rows(2 * unit_k + 1))
    return np.asarray(seq), steps


def _edge_batch(rng):
    """Edited pairs inside the band plus `chip_smoke.walk_edge_pairs`, an
    empty pair first: 41 pairs, one more than a multiple of the block."""
    a_list, b_list = _pairs(rng, 33, 60, UK)
    a_e, b_e = cs.walk_edge_pairs(rng, UK, MAX_M)
    a_list, b_list = a_list + a_e, b_list + b_e
    while len(a_list) % BLOCK != 9:
        a_list.append(np.empty(0, np.uint8))
        b_list.append(np.empty(0, np.uint8))
    return a_list, b_list


@pytest.mark.parametrize("c", COSTS, ids=COST_IDS)
def test_walk_equals_jax_walks_and_scalar_decode(c):
    rng = np.random.default_rng(900 + c[0] + 10 * (c[3] or 0))
    a_list, b_list = _edge_batch(rng)
    B = len(a_list)
    t = tlb.prepare_band_tensors(a_list, b_list, UK, MAX_M, device="cpu")
    d, codes = tlb.band_trace(*t, unit_k=UK, costs_t=_ct(c))
    runs, counts, seq = _walk(codes, t, UK)
    steps = ttw.walk_steps(t[0].shape[1], UK)
    assert seq.shape == (B, steps) and counts.shape == (B,)
    assert int(counts.sum()) == runs.shape[0]
    plain = ttw.trace_walk_plain(codes, *t, unit_k=UK)
    assert torch.equal(runs, plain[0]) and torch.equal(counts, plain[1])
    # the JAX package's packed walk over the same codes
    seq_ref, steps_ref = _jax_walk(codes, t, UK)
    assert steps_ref == steps and np.array_equal(seq.numpy(), seq_ref)
    # the JAX package's own scan and walk (its int32 layout, same max_m)
    a_pad, b_pad, m, n = jbs.prepare_band_inputs(a_list, b_list, UK,
                                                 t[0].shape[1])
    d_j, seq_j, _ = jbs.band_trace_batch(a_pad, b_pad, m, n, unit_k=UK,
                                         max_m=t[0].shape[1],
                                         costs_t=_ct(c))
    assert d.tolist() == np.asarray(d_j).tolist()
    assert np.array_equal(seq.numpy(), np.asarray(seq_j))
    # the decode over runs against the JAX decode over steps and the
    # scalar walk over the unpacked codes
    swaps = [bool(p % 2) for p in range(B)]
    walked = tbs.decode_walked_batch(runs.numpy(), counts.numpy(), swaps)
    ref = jbs.decode_walked_batch(np.asarray(seq_j), swaps)
    assert [_fields(x) for x in walked] == [_fields(x) for x in ref]
    cells = tbs.unpack_codes(codes, 2 * UK + 1).numpy()
    for p, (a, b) in enumerate(zip(a_list, b_list)):
        host = tbs.decode_traceback(cells[p], a, b, UK, swaps[p])
        assert _fields(walked[p]) == _fields(host), p
    # the edges were reached: each edge cell on its pair's walk, the empty
    # pairs walk no step, the transposition is the walk's last step
    n_e = len(cs.walk_edge_pairs(np.random.default_rng(0), UK, MAX_M)[0])
    seen = set()
    for p in range(33, 33 + n_e - 2):
        seen |= set(cs.walk_cells(seq[p].numpy(), len(a_list[p]),
                                  len(b_list[p]), UK))
    assert {0, 15, 16, 31, 32} <= seen
    assert int(counts[B - 1]) == int(counts[0]) == 0
    last = seq[33 + n_e - 2]
    if c[3] is not None:
        assert int(last[(last >= 0).sum() - 1]) == 4


def test_longest_walk_reaches_the_bound():
    a, b = cs.longest_walk_pair(UK, MAX_M)
    a_list, b_list = [a, a[:5]], [b, b[:9]]
    t = tlb.prepare_band_tensors(a_list, b_list, UK, MAX_M, device="cpu")
    ct = _ct(cs.LONGEST_WALK_COSTS)
    d, codes = tlb.band_trace(*t, unit_k=UK, costs_t=ct)
    runs, counts, seq = _walk(codes, t, UK)
    steps = ttw.walk_steps(t[0].shape[1], UK)
    assert steps == 2 * MAX_M + UK + 1
    assert int((seq[0] >= 0).sum()) == steps - 1 == len(a) + len(b)
    assert int((runs[:int(counts[0])] >> 3).sum()) == steps - 1
    assert set((runs & 7).tolist()) <= {2, 3}
    assert int(d[0]) == len(a) + len(b)
    seq_ref, _ = _jax_walk(codes, t, UK)
    assert np.array_equal(seq.numpy(), seq_ref)


@pytest.mark.parametrize("unit_k", [0, 16])
def test_walk_on_random_codes_equals_jax(unit_k):
    """Codes the band kernel would never write: walks that step past row 0
    or column 0 and keep walking until the bound, as the JAX walk does."""
    rng = np.random.default_rng(77 + unit_k)
    B, max_m = 37, 32
    W = 2 * unit_k + 1
    m = rng.integers(0, max_m + 1, B).astype(np.int32)
    n = (m + rng.integers(0, unit_k + 1, B)).astype(np.int32)
    codes = torch.from_numpy(rng.integers(
        -(1 << 31), 1 << 31, (B, max_m, tbs.code_words(W)), dtype=np.int64)
        .astype(np.int32))
    t = (torch.from_numpy(rng.integers(65, 69, (B, max_m)).astype(np.uint8)),
         torch.from_numpy(rng.integers(65, 69, (B, max_m + W))
                          .astype(np.uint8)),
         torch.from_numpy(m), torch.from_numpy(n))
    runs, _, seq = _walk(codes, t, unit_k)
    seq_ref, _ = _jax_walk(codes, t, unit_k)
    assert np.array_equal(seq.numpy(), seq_ref)
    assert ((runs & 7) == 4).any()


def test_single_runs_as_long_as_the_walk():
    """An identical pair as long as the batch's rows walks one Match run of
    m steps; codes that say consume-b everywhere walk one run past (i, 0)
    to the `steps` cap (j and the clipped cells go negative while i > 0),
    the longest run a batch can hold; an empty a walks one row-0 run of n
    steps."""
    rng = np.random.default_rng(5)
    max_m, unit_k = 48, 16
    W = 2 * unit_k + 1
    s = cs.ACGT[rng.integers(0, 4, max_m)]
    a_list = [s, s[:20], np.empty(0, np.uint8)]
    b_list = [s.copy(), s[:20].copy(), s[:unit_k]]
    t = tlb.prepare_band_tensors(a_list, b_list, unit_k, max_m, device="cpu")
    _, codes = tlb.band_trace(*t, unit_k=unit_k, costs_t=(1, 1, 0, 0, False))
    codes[1] = 0x55555555  # every cell of pair 1: consume-b
    runs, counts, seq = _walk(codes, t, unit_k)
    steps = ttw.walk_steps(max_m, unit_k)
    assert counts.tolist() == [1, 1, 1]
    assert runs.tolist() == [max_m << 3, steps << 3 | 2, unit_k << 3 | 2]
    seq_ref, _ = _jax_walk(codes, t, unit_k)
    assert np.array_equal(seq.numpy(), seq_ref)
    assert [_fields(x) for x in tbs.decode_walked_batch(
        runs.numpy(), counts.numpy(), [False, True, True])] == [
            [("Match", max_m)], [("BGap", steps)], [("BGap", unit_k)]]


def test_decode_shares_one_edit_per_distinct_run():
    """Random run streams: the decode equals the JAX package's decode of
    the same steps, and every (edit, count) is one object, shared by every
    list that holds it."""
    rng = np.random.default_rng(31)
    seq = np.full((40, 60), -1, np.int8)
    for p in range(40):
        ln = int(rng.integers(0, 61))
        seq[p, :ln] = np.repeat(rng.integers(0, 5, ln), 3)[:ln]
    swaps = [bool(x) for x in rng.integers(0, 2, 40)]
    runs, counts = tbs.run_length_encode(torch.from_numpy(seq))
    got = tbs.decode_walked_batch(runs.numpy(), counts.numpy(), swaps)
    assert [_fields(x) for x in got] == \
        [_fields(x) for x in jbs.decode_walked_batch(seq, swaps)]
    objs = {}
    for edits in got:
        for e in edits:
            assert objs.setdefault((e.edit, e.count), e) is e
    assert len(objs) < sum(len(x) for x in got)
    keep = np.array([p % 3 != 0 for p in range(40)])
    part = tbs.decode_walked_batch(runs.numpy(), counts.numpy(), swaps, keep)
    assert [_fields(x) for x in part] == \
        [_fields(x) if k else None for x, k in zip(got, keep)]


def test_trace_walk_checks_its_inputs():
    t = tlb.prepare_band_tensors([np.zeros(3, np.uint8)],
                                 [np.zeros(5, np.uint8)], 4, 8, device="cpu")
    _, codes = tlb.band_trace(*t, unit_k=4, costs_t=(1, 1, 0, 0, False))
    with pytest.raises(TypeError):
        ttw.trace_walk(codes.to(torch.int64), *t, unit_k=4)
    with pytest.raises(TypeError):
        ttw.trace_walk(codes, t[0].to(torch.int32), *t[1:], unit_k=4)
    with pytest.raises(ValueError, match="words"):
        ttw.trace_walk(codes, *t, unit_k=40)
    with pytest.raises(ValueError, match="row lengths"):
        ttw.trace_walk(codes, t[0], t[1][:, :-1], *t[2:], unit_k=4)
    with pytest.raises(ValueError, match="int32"):
        ttw.trace_walk(codes, *t[:2], t[2].to(torch.int64), t[3], unit_k=4)
    with pytest.raises(ValueError, match="same B"):
        ttw.trace_walk(codes, t[0][:0], *t[1:], unit_k=4)
    with pytest.raises(ValueError, match="unsupported device"):
        ttw.trace_walk(*(x.to("meta") for x in (codes, *t)), unit_k=4)
    with pytest.raises(ValueError, match="negative"):
        ttw.trace_walk(codes, *t, unit_k=-1)
    runs, counts, seq = _walk(codes, t, 4)
    assert seq.shape[1] == 2 * 16 + 4 + 1 and int((seq[0] >= 0).sum()) == 5
    edits = tbs.decode_walked_batch(runs.numpy(), counts.numpy(), [False])[0]
    assert cs.replay_cost(np.zeros(3, np.uint8), np.zeros(5, np.uint8),
                          edits, EditCosts(1, 1, 0, None)) == 2


def test_walks_past_the_run_count_limit_raise():
    """A batch whose walks could reach 2^28 steps (max_m 2^27: steps =
    2^28 + unit_k + 1) raises before anything is walked, on the CPU and
    (meta tensors stand in for the card's) before any launch; one row
    less fits."""
    for max_m, raises in ((1 << 27, True), ((1 << 27) - 3, False)):
        t = [torch.empty((1, max_m), dtype=torch.uint8, device="meta"),
             torch.empty((1, max_m + 9), dtype=torch.uint8, device="meta"),
             torch.empty(1, dtype=torch.int32, device="meta"),
             torch.empty(1, dtype=torch.int32, device="meta")]
        codes = torch.empty((1, max_m, 1), dtype=torch.int32, device="meta")
        assert (ttw.walk_steps(max_m, 4) >= tbs.RUN_COUNT_LIMIT) == raises
        with pytest.raises(ValueError,
                           match="2\\^28" if raises else "unsupported"):
            ttw.trace_walk(codes, *t, unit_k=4)
    with pytest.raises(ValueError, match="2\\^28"):
        tbs.run_length_encode(torch.empty((0, 1 << 28), dtype=torch.int8,
                                          device="meta"))


def test_band_plan_takes_traced_bands_past_the_cap():
    # the cluster regime: the `past_plan` cell, 128 pairs of b strings up
    # to 10,010 bytes at unit_k 10,016
    W = 2 * 10_016 + 1
    plan = tlb.band_plan(10_016, 10_016, True, batch=128, max_n=10_010)
    assert plan["regime"] == "wide_cluster" and plan["smem_bytes"] == 0
    assert plan["ctas_per_pair"] * plan["threads"] * 16 >= 10_010 + 3
    assert plan["threads"] <= 32 * tlb.CLUSTER_MAX_WARPS
    assert 1 <= plan["ctas_per_pair"] <= tlb.CLUSTER_MAX_CTAS
    # a band as wide as the matrix: one strip a warp, the map of the sweep
    assert (plan["ctas_per_pair"], plan["threads"]) == (2, 320)
    assert plan["scratch_bytes_per_pair"] == 16 * (10_016 + 2)
    assert plan["code_bytes_per_pair"] == 10_016 * tbs.code_words(W) * 4
    # b strings past what a cluster held at once (81,917 bytes): the same
    # regime, its warps a ring over the strips that meet a row: band
    # 10,017 (case (e) of chip_smoke's band_wide phase) meets 21 strips
    # of 512 columns, not the 176 of 90,000-byte strings: 24 warps of 4
    # for 2 pairs, 20 of 10 for a batch that fills the card
    W = 2 * 5008 + 1
    for batch, ctas, warps in ((2, 6, 4), (64, 2, 10), (None, 2, 10)):
        plan = tlb.band_plan(90_016, 5008, True, batch=batch,
                             max_n=90_000)
        assert plan["regime"] == "wide_cluster" and not plan["full_band"]
        assert (plan["ctas_per_pair"], plan["threads"] // 32) == (ctas, warps)
        assert plan["scratch_bytes_per_pair"] == 16 * (90_016 + 2)
        assert plan["code_bytes_per_pair"] == 90_016 * tbs.code_words(W) * 4
    assert tlb._cluster_map(90_016, 90_000, 5008, 2) == (6, 4)
    # past the INF rule (255 (m + unit_k + 3) >= 2^30) the strips cover
    # every band column, to column m + unit_k
    assert tlb.band_plan(4_300_000, 16_384, True, batch=1,
                         max_n=4_300_000)["full_band"]
    assert tlb._cluster_strips(4_000_000, 4_000_000, 1 << 20) \
        == -(-(4_000_000 + (1 << 20) + 1) // 512)
    assert tlb._cluster_strips(4_000_000, 4_000_000, 8) \
        == -(-(4_000_000 + 3) // 512)
    assert tlb.band_plan(10_016, tlb.MAX_TRACE_UNIT_K, True, batch=1,
                         max_n=1_000_000)["warps_per_pair"] == 160
    # untraced batches past the cap keep their kernels (K5, K9)
    assert tlb.band_plan(10_016, 16_384) is None
    assert tlb.band_plan(8, tlb.MAX_UNIT_K, True)["regime"] == "wide"
    assert tlb.band_plan(8, 2 * tlb.MAX_UNIT_K, True)["regime"] \
        == "wide_cluster"
    assert tlb.band_plan(8, tlb.MAX_TRACE_UNIT_K + 1, True) is None
    # a check may force the regime onto a narrow band, at any map and
    # with its strips over the whole band; not past its cap
    t = tlb.prepare_band_tensors([np.zeros(3, np.uint8)],
                                 [np.zeros(5, np.uint8)], 4, 8, device="cpu")
    forced = dict(tlb.band_plan(8, 2 * tlb.MAX_UNIT_K, True,
                                max_n=90_000), threads=64, full_band=True)
    cluster = cs.cluster_plan(8, 4, 1, 1)
    for plan in (forced, cluster):
        assert tlb.band_trace(*t, unit_k=4, costs_t=(1, 1, 0, 0, False),
                              plan=plan)[0].tolist() == [2]
    with pytest.raises(ValueError, match="plan"):
        tlb.band_trace(*t, unit_k=4, costs_t=(1, 1, 0, 0, False),
                       plan=dict(forced, threads=48))
    with pytest.raises(ValueError, match="cluster plan"):
        tlb.band_distance(*t, unit_k=4, costs_t=(1, 1, 0, 0, False),
                          plan=cluster)
    with pytest.raises(ValueError, match="band plan"):
        tlb.band_distance(*t, unit_k=2 * tlb.MAX_UNIT_K,
                          costs_t=(1, 1, 0, 0, False))
    # a cluster of one warp takes a b past its 512 columns (two strips in
    # turn); a batch past the INF rule needs a plan whose strips cover
    # the band
    t = tlb.prepare_band_tensors([np.zeros(3, np.uint8)],
                                 [np.zeros(510, np.uint8)], 508, 8,
                                 device="cpu")
    assert tlb.band_trace(*t, unit_k=508, costs_t=(1, 1, 0, 0, False),
                          plan=cs.cluster_plan(8, 508, 1, 1))[0].tolist() \
        == [507]
    rows = 4_300_000
    t = (torch.empty((1, rows), dtype=torch.uint8, device="meta"),
         torch.empty((1, rows + 2 * 5000 + 1), dtype=torch.uint8,
                     device="meta"),
         torch.empty(1, dtype=torch.int32, device="meta"),
         torch.empty(1, dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError, match="cluster plan"):
        tlb.band_trace(*t, unit_k=5000, costs_t=(1, 1, 0, 0, False),
                       plan=dict(cs.cluster_plan(rows, 5000, 1, 1),
                                 full_band=False), max_n=rows)


def test_traced_batch_past_the_plan_equals_jax():
    """The route that raised until the walk and the band kernel's
    device-memory regime were ported: the shortest pairs past the band
    plan (n = 4,700, unbounded threshold: unit_k 4,704, band 9,409, past
    the 227 KB of a block's shared memory), edited ACGT copies under
    rDamerau costs, against the JAX package's `trace_batch` engine and the
    compiled scalar comparator."""
    rng = np.random.default_rng(4100)
    a = cs.ACGT[rng.integers(0, 4, 4696)]
    b = a.copy()
    b[rng.integers(0, 4696, 40)] = cs.ACGT[rng.integers(0, 4, 40)]
    b = np.insert(b, rng.integers(0, 4696, 4), cs.ACGT[:4])
    b[100], b[101] = b[101], b[100]
    got_d, got_t = tl.levenshtein_k_batch([a], [b], tl.U32_MAX,
                                          EditCosts(1, 1, 0, 1), True,
                                          device="cpu")
    assert last_dispatch().path == "band_trace_global"
    assert last_dispatch().unit_k == 4704
    ref_d, ref_t = jl.levenshtein_k_batch([a], [b], jl.U32_MAX,
                                          JEditCosts(1, 1, 0, 1), True)
    assert got_d.tolist() == np.asarray(ref_d).tolist()
    assert _fields(got_t[0]) == _fields(ref_t[0])
    assert got_d.tolist() == scalar_banded_batch_native(
        [a], [b], tl.U32_MAX, EditCosts(1, 1, 0, 1)).tolist()
    assert cs.replay_cost(a, b, got_t[0], EditCosts(1, 1, 0, 1)) \
        == int(got_d[0]) > 0


def _traced(a_list, b_list, k, monkeypatch=None):
    """`levenshtein_k_batch` traced on the CPU, rDamerau costs, against the
    JAX package field by field; (distances, traces, what the decode was
    asked to keep)."""
    kept = []
    if monkeypatch is not None:
        decode = tbs.decode_walked_batch

        def spy(runs, counts, swaps, keep=None):
            kept.append(keep)
            return decode(runs, counts, swaps, keep)

        monkeypatch.setattr(tbs, "decode_walked_batch", spy)
    got_d, got_t = tl.levenshtein_k_batch(a_list, b_list, k,
                                          EditCosts(1, 1, 0, 1), True,
                                          device="cpu")
    assert last_dispatch().path == "band_trace"
    ref_d, ref_t = jl.levenshtein_k_batch(a_list, b_list, k,
                                          JEditCosts(1, 1, 0, 1), True)
    assert got_d.tolist() == np.asarray(ref_d).tolist()
    assert [_fields(x) for x in got_t] == [_fields(x) for x in ref_t]
    return got_d, got_t, kept


def test_swapped_and_unswapped_pairs_in_one_batch():
    """Pairs with len(a) > len(b) (walked swapped, AGap and BGap traded
    back) beside pairs with len(a) <= len(b), at a threshold every pair
    meets: the JAX package's traces and the oracle's distances."""
    rng = np.random.default_rng(41)
    a_list, b_list = _pairs(rng, 24, 40)
    swapped = [len(a) > len(b) for a, b in zip(a_list, b_list)]
    assert 4 <= sum(swapped) <= 20
    d, traces, _ = _traced(a_list, b_list, 100)
    for p, (a, b) in enumerate(zip(a_list, b_list)):
        ref = _naive(a, b, 100, True, EditCosts(1, 1, 0, 1))
        assert int(d[p]) == ref[0]
        assert cs.replay_cost(a, b, traces[p], EditCosts(1, 1, 0, 1)) \
            == ref[0]


def test_pairs_past_the_threshold_are_not_decoded(monkeypatch):
    """At k = 3 the unrelated pairs among edited copies are past the
    threshold: -1 and None, as in the JAX package, and the decode is asked
    for the others only."""
    rng = np.random.default_rng(43)
    a_list, b_list = _pairs(rng, 16, 30)
    for ln in (8, 20, 30, 30):
        a_list.append(rng.integers(65, 70, ln).astype(np.uint8))
        b_list.append(rng.integers(65, 70, ln + 2).astype(np.uint8))
    d, traces, kept = _traced(a_list, b_list, 3, monkeypatch)
    past = d < 0
    assert 4 <= int(past.sum()) <= 16
    assert [t is None for t in traces] == past.tolist()
    assert len(kept) == 1 and kept[0].tolist() == (~past).tolist()


def test_runs_join_across_trace_chunks(monkeypatch):
    """A `_TRACE_CODE_BYTES_CAP` that holds three pairs' codes and run
    buffers cuts 20 pairs into seven launches; the runs of the chunks,
    joined by their counts, decode to the unchunked call's traces."""
    rng = np.random.default_rng(47)
    a_list, b_list = _pairs(rng, 20, 40)
    d_one, t_one, _ = _traced(a_list, b_list, 20)
    dec = last_dispatch()
    plan = tlb.band_plan(dec.padded_m, dec.unit_k, True,
                         max_n=max(max(len(a), len(b))
                                   for a, b in zip(a_list, b_list)))
    per_pair = plan["code_bytes_per_pair"] + ttw.run_bytes_per_pair(
        dec.padded_m, dec.unit_k)
    calls = []
    walk = ttw.trace_walk

    def counted(*args, **kw):
        calls.append(args[0].shape[0])
        return walk(*args, **kw)

    monkeypatch.setattr(tl, "_TRACE_CODE_BYTES_CAP", 3 * per_pair + 1)
    monkeypatch.setattr(ttw, "trace_walk", counted)
    d, traces, _ = _traced(a_list, b_list, 20)
    assert calls == [3] * 6 + [2]
    assert d.tolist() == d_one.tolist()
    assert [_fields(x) for x in traces] == [_fields(x) for x in t_one]


# chip_smoke.py's helpers of the walk's checks on the card

@pytest.mark.parametrize("unit_k,max_m", [(0, 16), (16, 80), (600, 2500)])
def test_walk_edge_pairs_satisfy_the_kernel_contract(unit_k, max_m):
    a_list, b_list = cs.walk_edge_pairs(np.random.default_rng(7), unit_k,
                                        max_m)
    la = np.array([len(a) for a in a_list])
    lb = np.array([len(b) for b in b_list])
    assert ((la <= lb) & (lb - la <= unit_k) & (la <= max_m)).all()
    assert la[-1] == 0 < lb[-1] or unit_k == 0
    assert bytes(a_list[-2][:2]) == b"CA" and bytes(b_list[-2][:2]) == b"AC"
    W = 2 * unit_k + 1
    assert len(a_list) == 2 + len({c for c in cs.WALK_EDGE_CELLS if c < W}
                                  | {W - 1})
    # the cheapest alignment of an edge pair runs along its cell: the
    # oracle's traceback, walked from (0, 0), passes it
    if unit_k == 16:
        for cell, a, b in zip(sorted(set(cs.WALK_EDGE_CELLS) | {W - 1}),
                              a_list, b_list):
            _, edits = _naive(a, b, 10**6, True,
                                                     _LEV)
            i = j = 0
            cells = {unit_k}
            for e in edits:
                for _ in range(e.count):
                    di, dj = {"Match": (1, 1), "Mismatch": (1, 1),
                              "AGap": (0, 1), "BGap": (1, 0)}[e.edit.name]
                    i, j = i + di, j + dj
                    cells.add(j - i + unit_k)
            assert cell in cells


def test_walk_gap_pairs_and_run_helpers():
    """`chip_smoke.walk_gap_pairs`: each pair's cheapest alignment holds a
    gap run of `gap` steps (the oracle's traceback; the walk leaves a
    window of fewer cells sideways) and keeps n - m <= gap; the swapped
    copy's holds transpositions.  The helpers that read runs on the card:
    a pair's runs, the steps each pair walked, the runs' disagreement."""
    rng = np.random.default_rng(11)
    a_list, b_list = cs.walk_gap_pairs(rng, 240, 60)
    assert all(0 <= len(b) - len(a) <= 60 for a, b in zip(a_list, b_list))
    for p, (a, b) in enumerate(zip(a_list, b_list)):
        _, edits = _naive(a, b, 10**6, True, EditCosts(1, 1, 0, 1))
        if p < 2:
            assert max(e.count for e in edits
                       if e.edit.name in ("AGap", "BGap")) >= 60
        else:
            assert sum(e.count for e in edits
                       if e.edit.name == "Transpose") >= 20
    seq = torch.tensor([[2, 2, 0, -1], [-1] * 4, [4, 4, 4, 1]],
                       dtype=torch.int8)
    runs, counts = tbs.run_length_encode(seq)
    assert cs.pair_runs(runs, counts, 2).tolist() == [3 << 3 | 4, 1 << 3 | 1]
    assert prof.walk_lengths(runs, counts).tolist() == [3, 0, 4]
    assert cs.runs_err((runs, counts), (runs.clone(), counts.clone())) == 0
    other = runs.clone()
    other[1] += 8
    assert cs.runs_err((runs, counts), (other, counts)) == 8
    assert cs.runs_err((runs, counts), (runs[:3], counts)) > 0


def test_walk_cells_longest_pair_and_k10_bound():
    # a stream in reverse walk order from (3, 5): consume-b twice, then
    # three diagonals, at unit_k 4
    seq = np.array([2, 2, 0, 1, 0, -1, -1], np.int8)
    assert cs.walk_cells(seq, 3, 5, 4) == [6, 5, 4, 4, 4, 4]
    assert cs.walk_cells(np.array([4, -1], np.int8), 2, 2, 1) == [1, 1]
    a, b = cs.longest_walk_pair(4, 16)
    assert len(a) == 16 and len(b) == 20 and not set(a) & set(b)
    seqs = torch.tensor([[2, 2, 0, 1, 0, -1, -1], [-1] * 7], dtype=torch.int8)
    runs, counts = tbs.run_length_encode(seqs)
    assert counts.tolist() == [4, 0]
    bound = prof.k10_bound(runs, counts, 7)
    assert bound["walked_steps"] == 5 and bound["longest_walk"] == 5
    assert bound["runs"] == 4
    assert bound["bound_bytes_ms"] == pytest.approx(
        (5 * prof.K10_CODE_BYTES + 3 * prof.K10_CHAR_BYTES
         + 4 * prof.K10_RUN_BYTES + 2 * 4 + 16) / prof.PEAK_BYTES_PER_S * 1e3)
    assert bound["bound_by"] == "bytes"
    assert bound["bound_operations_ms"] == pytest.approx(
        5 * prof.K10_OPS_PER_STEP / prof.PEAK_INT32_OPS_PER_S * 1e3)
    assert bound["bound_ms"] == bound["bound_bytes_ms"]
