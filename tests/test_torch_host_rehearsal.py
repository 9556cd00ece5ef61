"""The CUDA kernels' bodies, compiled for the host, against their plain
PyTorch versions and the oracle.

`csrc/myers_distance.cu`, `csrc/myers_search.cu`, `csrc/band_distance.cu`,
`csrc/myers_blocked.cu`, `csrc/search_diag.cu`, `csrc/search_flat.cu` and
`csrc/trace_walk.cu` keep their per-pair, per-segment, per-row and per-lane code in plain
functions that also compile with a host C++ compiler
(`-DTA_HOST_REHEARSAL`);
`csrc/host_rehearsal.cpp` wraps them in a C interface that runs one
"thread" at a time.  So the arithmetic the card
runs is checked here, where no CUDA compiler exists: integer results, exact
equality with the plain versions (the code the kernels are held against on
the card), and the band / halo contract against the oracle.  What this
cannot see is what only the device build has: the launch geometry, the
shared-memory layout across threads and the vector load/store instructions.
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

import chip_smoke as cs
from triple_accel_tpu_torch.ops import band_scan as bs
from triple_accel_tpu_torch.ops import lev_band as lb
from triple_accel_tpu_torch.ops import myers_chunked as mc
from triple_accel_tpu_torch.ops import myers_distance as md
from triple_accel_tpu_torch.ops import myers_search as ms
from triple_accel_tpu_torch.ops import search_diag as sd
from triple_accel_tpu_torch.ops import search_flat as sf
from triple_accel_tpu_torch.ops import trace_walk as ttw
from triple_accel_tpu_torch.ops.search_common import seg_count, window_span
from triple_accel_tpu_torch.oracle import (
    levenshtein_naive_k_with_opts,
    levenshtein_search_naive_with_opts,
)
from triple_accel_tpu_torch.utils.native import (
    myers_distance_batch_native,
    scalar_banded_batch_native,
    search_all_native,
)
from triple_accel_tpu_torch.types import (
    EditCosts,
    LEVENSHTEIN_COSTS,
    RDAMERAU_COSTS,
    SearchType,
)

# one intra-op thread: the test workers run side by side on the
# machine's cores
torch.set_num_threads(1)

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "triple_accel_tpu_torch", "csrc")


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++") or shutil.which("clang++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    so = str(tmp_path_factory.mktemp("rehearsal") / "libta_rehearsal.so")
    res = subprocess.run(
        [cxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-I", CSRC,
         os.path.join(CSRC, "host_rehearsal.cpp"), "-o", so],
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    lib = ctypes.CDLL(so)
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.ta_rehearse_distance.restype = ctypes.c_int
    lib.ta_rehearse_distance.argtypes = [vp] * 6 + [i64, i64, i64, i32]
    lib.ta_rehearse_search.restype = ctypes.c_int
    lib.ta_rehearse_search.argtypes = [
        vp, i64, vp, i32, i32, i64, i64, i64, i32, i32, vp, i64, i32]
    lib.ta_rehearse_band.restype = ctypes.c_int
    lib.ta_rehearse_band.argtypes = (
        [vp] * 6 + [i64, i64, i64, i32, i64] + [i32] * 8)
    lib.ta_rehearse_band_block.restype = ctypes.c_int
    lib.ta_rehearse_band_block.argtypes = (
        [vp] * 6 + [i64, i64, i64, i32, i64] + [i32] * 8)
    lib.ta_rehearse_band_cluster.restype = ctypes.c_int
    lib.ta_rehearse_band_cluster.argtypes = (
        [vp] * 6 + [i64, i64, i64, i32, i64] + [i32] * 9)
    lib.ta_rehearse_trace_walk.restype = ctypes.c_int
    lib.ta_rehearse_trace_walk.argtypes = (
        [vp] * 7 + [i64] * 5 + [i32, i64] + [i32] * 3)
    lib.ta_rehearse_trace_walk_gather.restype = ctypes.c_int
    lib.ta_rehearse_trace_walk_gather.argtypes = [vp] * 4 + [i64] * 2
    lib.ta_rehearse_blocked_distance.restype = ctypes.c_int
    lib.ta_rehearse_blocked_distance.argtypes = (
        [vp] * 5 + [i32, i32, vp, i64, i64, i64, vp, i64, i32])
    lib.ta_rehearse_blocked_search.restype = ctypes.c_int
    lib.ta_rehearse_blocked_search.argtypes = [
        vp, i64, vp, i32, i32, vp, i32, i32, i32, i32, i64, i64, i64, i32,
        i32, vp, i64, vp, i64]
    lib.ta_rehearse_search_diag.argtypes = [
        vp, i64, vp, i32, i64, i64, i64, i32, i32, i32, i32, i32, i32, i32,
        i32, i32, vp, vp]
    lib.ta_rehearse_flat_search.argtypes = [
        vp, i64, vp, i32, i64, i64, vp, i64, i32, i32, i32, i32, i32, i32,
        vp, vp, vp, i32, i32]
    lib.ta_rehearse_flat_distance.argtypes = [
        vp, vp, vp, vp, i64, i64, i64, i32, i32, i32, i32, i32, i32, vp, vp,
        i32, i32]
    for name in ("ta_rehearse_search_diag", "ta_rehearse_flat_search",
                 "ta_rehearse_flat_distance"):
        getattr(lib, name).restype = ctypes.c_int
    return lib


def _pairs(rng, n_pairs, max_m, k, nul):
    a_list, b_list = [], []
    while len(a_list) < n_pairs:
        m = int(rng.integers(0, max_m + 1))
        a = rng.integers(65, 70, m).astype(np.uint8)
        if nul and m:
            a[rng.integers(0, m, 2)] = 0  # NUL chars: pads are 0 too
        b = list(a)
        for _ in range(int(rng.integers(0, max(k, 1) * 2))):
            op = rng.integers(0, 3)
            if op == 0 and b:
                b[rng.integers(0, len(b))] = rng.integers(65, 70)
            elif op == 1:
                b.insert(int(rng.integers(0, len(b) + 1)),
                         int(rng.integers(65, 70)))
            elif op == 2 and b:
                del b[rng.integers(0, len(b))]
        b = np.array(b, dtype=np.uint8)
        if len(a) > len(b):
            a, b = b, a
        if len(b) - len(a) > k or len(a) > max_m:
            continue
        a_list.append(a)
        b_list.append(b)
    a_list[0] = b_list[0] = np.empty(0, np.uint8)  # the empty pair
    return a_list, b_list


# thresholds at both sides of every word boundary of the band (k + 1 = 64,
# 128, 192) and the widest the plan holds
@pytest.mark.parametrize("k,max_m", [
    (0, 16), (4, 16), (32, 64), (63, 64), (64, 64), (127, 64), (128, 48),
    (159, 32), (191, 200),
])
@pytest.mark.parametrize("nul", [False, True], ids=["plainchars", "nul"])
def test_distance_body_equals_plain_version_and_oracle(lib, k, max_m, nul):
    rng = np.random.default_rng(1000 * k + max_m + int(nul))
    a_list, b_list = _pairs(rng, 60, max_m, k, nul)
    ks = np.maximum(rng.integers(0, k + 1, len(a_list)),
                    [len(b) - len(a) for a, b in zip(a_list, b_list)])
    exp = [levenshtein_naive_k_with_opts(a, b, 10**9, False)[0]
           for a, b in zip(a_list, b_list)]
    for per_pair in (None, ks):
        t = md.prepare_myers_inputs(a_list, b_list, k, max_m, ks=per_pair,
                                    device="cpu")
        plain = md.myers_distance_plain(*t, k=k).numpy()
        arrs = [x.numpy() for x in t]
        out = np.full(len(a_list), -7, np.int32)
        rc = lib.ta_rehearse_distance(
            *[x.ctypes.data for x in arrs], out.ctypes.data, len(a_list),
            arrs[0].shape[1], arrs[1].shape[1], md.myers_plan(k)[0])
        assert rc == 0
        assert np.array_equal(out, plain)
        for p, (g, e) in enumerate(zip(out, exp)):
            kp = k if per_pair is None else int(per_pair[p])
            assert g >= e, f"pair {p}: {g} below the truth {e}"
            assert (g == e) if e <= kp else (g > kp), (p, g, e, kp)


# needle lengths at both sides of the 64-bit word boundaries, one in the
# many-word kernel; own_len not a multiple of 4 exercises the scalar edges
# of the four-column stores
@pytest.mark.parametrize("m", [1, 5, 24, 64, 65, 128, 130, 700])
@pytest.mark.parametrize("damerau", [False, True], ids=["unit", "rdamerau"])
@pytest.mark.parametrize("anchored", [False, True],
                         ids=["unanchored", "anchored"])
def test_search_body_equals_plain_version_and_oracle(lib, m, damerau,
                                                     anchored):
    rng = np.random.default_rng(7 * m + 2 * int(damerau) + int(anchored))
    costs = RDAMERAU_COSTS if damerau else LEVENSHTEIN_COSTS
    k = min(m, 6)
    for own_choice in (13, 64, 250):
        n = int(rng.integers(0, 400)) if m < 200 else 900
        needles = np.stack([rng.integers(65, 69, m).astype(np.uint8)
                            for _ in range(2)])
        needles[0, rng.integers(0, m)] = 0  # a NUL needle byte ...
        hay = rng.integers(65, 69, n).astype(np.uint8)
        if n:
            hay[0] = 0  # ... against a haystack that starts with NUL
        if n > m + 5:
            hay[3: 3 + m] = needles[1]
            if m > 4:  # one transposition inside the planted copy
                hay[4], hay[5] = hay[5], hay[4]
        if anchored:
            it, halo = min(m + k, n), 0
            own = max(it, 1)
        else:
            it, halo, own = n, min(window_span(m, k, 1, 0), n), own_choice
        h = hay[:it].copy()
        plain = ms.myers_search_plain(
            torch.from_numpy(h), torch.from_numpy(needles), own_len=own,
            halo=halo, anchored=anchored, damerau=damerau).numpy()
        stride = -(-(it + 1) // 4) * 4
        out = np.full((2, stride), -7, np.int32)
        rc = lib.ta_rehearse_search(
            h.ctypes.data, it, needles.ctypes.data, 2, m, own, halo,
            seg_count(it, own), int(anchored), int(damerau),
            out.ctypes.data, stride, ms.myers_search_plan(m)[0])
        assert rc == 0
        assert np.array_equal(out[:, : it + 1], plain)
        assert (out[:, it + 1:] == -7).all()  # pad columns stay unwritten
        for i in range(2):
            ref = {mt.end: mt.k for mt in levenshtein_search_naive_with_opts(
                needles[i], hay, k, SearchType.All, costs, anchored)}
            got = {j: int(out[i, j]) for j in range(it + 1)
                   if out[i, j] <= k}
            assert got == ref


@pytest.mark.parametrize("k", cs.DIST_EDGE_KS,
                         ids=[f"k{k}" for k in cs.DIST_EDGE_KS])
def test_distance_edges_equal_plain_version_and_oracle(lib, k):
    """K1's head / body split and word edges (chip_smoke.distance_edge_cases:
    ukL 0, 1 and k // 2, lengths 0 and one under, at and over multiples of
    16), per-pair thresholds and the batch threshold; exact against the
    plain version, the band contract against the oracle."""
    rng = np.random.default_rng(4000 + k)
    a_list, b_list, ks, max_m = cs.distance_edge_cases(rng, k)
    exp = [levenshtein_naive_k_with_opts(a, b, 10**9, False)[0]
           for a, b in zip(a_list, b_list)]
    for per_pair in (ks, None):
        t = md.prepare_myers_inputs(a_list, b_list, k, max_m, ks=per_pair,
                                    device="cpu")
        plain = md.myers_distance_plain(*t, k=k).numpy()
        arrs = [x.numpy() for x in t]
        out = np.full(len(a_list), -7, np.int32)
        rc = lib.ta_rehearse_distance(
            *[x.ctypes.data for x in arrs], out.ctypes.data, len(a_list),
            arrs[0].shape[1], arrs[1].shape[1], md.myers_plan(k)[0])
        assert rc == 0
        assert np.array_equal(out, plain)
        for p, (g, e) in enumerate(zip(out, exp)):
            kp = k if per_pair is None else int(per_pair[p])
            assert (g == e) if e <= kp else (g > kp), (p, g, e, kp)


@pytest.mark.parametrize(
    "case", cs.SEARCH_EDGE_CASES,
    ids=[f"m{c[0]}-n{c[1]}-own{c[2]}-halo{c[3]}"
         f"{'-anchored' if c[4] else ''}{'-rdamerau' if c[5] else ''}"
         for c in cs.SEARCH_EDGE_CASES])
def test_search_edges_equal_plain_version_and_oracle(lib, case):
    """K2's lanes, chunks and staged stores at their edges
    (chip_smoke.SEARCH_EDGE_CASES: every built word count's edge,
    haystacks one under and over multiples of 4, 16 and 32, owned lengths
    on and off the 16-byte chunk, halos reaching byte 0, two needles,
    anchored runs, both cost models): the lanes of a warp in turn, the
    staging area an array; exact against the plain version, pad columns
    unwritten, hits within k = 3 equal to the oracle's."""
    m, n, own, halo, anchored, damerau, _warps = case
    rng = np.random.default_rng(m * 7 + n)
    needles, hay = cs.search_edge_input(rng, m, n)
    plain = ms.myers_search_plain(
        torch.from_numpy(hay), torch.from_numpy(needles), own_len=own,
        halo=halo, anchored=anchored, damerau=damerau).numpy()
    stride = -(-(n + 1) // 4) * 4
    out = np.full((2, stride), -7, np.int32)
    rc = lib.ta_rehearse_search(
        hay.ctypes.data, n, needles.ctypes.data, 2, m, own, halo,
        seg_count(n, own), int(anchored), int(damerau), out.ctypes.data,
        stride, ms.myers_search_plan(m)[0])
    assert rc == 0
    assert np.array_equal(out[:, : n + 1], plain)
    assert (out[:, n + 1:] == -7).all()
    if m <= 100:
        costs = RDAMERAU_COSTS if damerau else LEVENSHTEIN_COSTS
        for i in range(2):
            ref = {mt.end: mt.k for mt in levenshtein_search_naive_with_opts(
                needles[i], hay, 3, SearchType.All, costs, anchored)}
            assert {j: int(out[i, j]) for j in range(n + 1)
                    if out[i, j] <= 3} == ref


BAND_COSTS = [(1, 1, 0, None), (1, 1, 0, 1), (2, 1, 2, None), (3, 2, 1, 2)]


def _band_pairs(rng, n_pairs, max_m, unit_k):
    """Edited copies inside the band, with adjacent swaps, NUL bytes, pairs
    at the band's edge (n - m == unit_k) and pairs with m == 0."""
    a_list, b_list = [], []
    while len(a_list) < n_pairs:
        p = len(a_list)
        m = int(rng.integers(0, max_m + 1))
        a = rng.integers(65, 69, m).astype(np.uint8)
        if m and p % 3 == 0:
            a[rng.integers(0, m, 2)] = 0  # NUL chars: pads are 0 too
        b = list(a)
        for _ in range(int(rng.integers(0, unit_k + 2))):
            op = rng.integers(0, 4)
            if op == 0 and b:
                b[rng.integers(0, len(b))] = rng.integers(65, 69)
            elif op == 1:
                b.insert(int(rng.integers(0, len(b) + 1)),
                         int(rng.integers(65, 69)))
            elif op == 2 and b:
                del b[rng.integers(0, len(b))]
            elif op == 3 and len(b) > 1:
                q = int(rng.integers(0, len(b) - 1))
                b[q], b[q + 1] = b[q + 1], b[q]
        b = np.array(b, dtype=np.uint8)
        if len(a) > len(b):
            a, b = b, a
        if p % 5 == 4:  # the band's edge
            b = np.concatenate(
                [b, rng.integers(65, 69, unit_k).astype(np.uint8)])
            b = b[: len(a) + unit_k]
        if len(b) - len(a) > unit_k or len(a) > max_m:
            continue
        a_list.append(a)
        b_list.append(b)
    a_list[0] = b_list[0] = np.empty(0, np.uint8)
    a_list[1] = np.empty(0, np.uint8)  # m == 0 against n > 0
    b_list[1] = b_list[1][:unit_k]
    return a_list, b_list


def _rehearse_walk(lib, codes, t, unit_k, shape=None):
    """K10's body over int32 codes [B, rows, wpr] (numpy) and the band
    tensors `t` at a launch shape (lanes, tile rows, window words; default
    the plan's), then its gather body, as the wrapper runs them: (runs,
    counts)."""
    arrs = [x.numpy() for x in t]
    codes = np.ascontiguousarray(codes)
    B, rows, wpr = codes.shape
    if shape is None:
        plan = ttw.walk_plan(2 * unit_k + 1, B)
        shape = (plan["lanes"], plan["tile_rows"], plan["window"])
    steps = ttw.walk_steps(arrs[0].shape[1], unit_k)
    buf = np.full((B, steps), -7, np.int32)  # garbage past each pair's runs
    counts = np.full(B, -7, np.int32)
    rc = lib.ta_rehearse_trace_walk(
        codes.ctypes.data, *[x.ctypes.data for x in arrs], buf.ctypes.data,
        counts.ctypes.data, B, rows, wpr, arrs[0].shape[1], arrs[1].shape[1],
        unit_k, steps, *shape)
    assert rc == 0 and (counts >= 0).all()
    ends = np.cumsum(counts, dtype=np.int64)
    runs = np.full(int(ends[-1]) if B else 0, -7, np.int32)
    assert lib.ta_rehearse_trace_walk_gather(
        buf.ctypes.data, counts.ctypes.data, ends.ctypes.data,
        runs.ctypes.data, B, steps) == 0
    return torch.from_numpy(runs), torch.from_numpy(counts)


def _same_runs(got, ref) -> bool:
    return all(torch.equal(g, r) for g, r in zip(got, ref))


def _band_check(lib, a_list, b_list, unit_k, max_m, costs, threads, cells,
                lanes, oracle=True, block=None):
    """The rehearsal (untraced and traced) at one launch plan against the
    plain version (distances, codes of rows 1..m, walked streams, K10's
    body walking the rehearsal's codes) and, with `oracle`, the oracle
    wherever the costs stay inside the band.  `block` (cells a lane, warps
    a pair, order of the warps in a round): the block regime (`threads`,
    `cells` and `lanes` are not read)."""
    B = len(a_list)
    ct = (costs[0], costs[1], costs[2], costs[3] or 0, costs[3] is not None)
    t = lb.prepare_band_tensors(a_list, b_list, unit_k, max_m, device="cpu")
    plain_d, plain_codes = bs.band_scan_distance(
        *t, unit_k=unit_k, costs_t=ct, trace_on=True)
    plain_seq, _ = bs.walk_packed_traceback(plain_codes, *t, unit_k=unit_k)
    arrs = [x.numpy() for x in t]
    rows, wpr = plain_codes.shape[1], plain_codes.shape[2]
    for traced in (False, True):
        out = np.full(B, -7, np.int32)
        codes = np.zeros((B, rows, wpr), np.int32)
        head = (*[x.ctypes.data for x in arrs], out.ctypes.data,
                codes.ctypes.data if traced else None, B, arrs[0].shape[1],
                arrs[1].shape[1], unit_k, rows, *ct[:4], int(ct[4]))
        if block is not None:
            rc = lib.ta_rehearse_band_block(*head, *block)
        else:
            rc = lib.ta_rehearse_band(*head, threads, cells, lanes)
        assert rc == 0
        assert np.array_equal(out, plain_d.numpy()), costs
        if traced:
            # rows past a pair's m are not written by the kernel body and
            # not read by the walk: compare the walked streams
            seq, _ = bs.walk_packed_traceback(
                torch.from_numpy(codes), *t, unit_k=unit_k)
            assert torch.equal(seq, plain_seq)
            assert _same_runs(_rehearse_walk(lib, codes, t, unit_k),
                              bs.run_length_encode(plain_seq))
            for p in range(B):
                mp = len(a_list[p])
                assert np.array_equal(codes[p, :mp],
                                      plain_codes[p, :mp].numpy()), (costs, p)
    if not oracle:
        return
    kband = unit_k * ct[1] + ct[2]  # costs up to this stay inside the band
    decoded = bs.decode_walked_batch(*bs.run_length_encode(plain_seq),
                                     [False] * B)
    for p, (a, b) in enumerate(zip(a_list, b_list)):
        ref = levenshtein_naive_k_with_opts(a, b, kband, True,
                                            EditCosts(*costs))
        if ref is not None:
            assert int(plain_d[p]) == ref[0] and decoded[p] == ref[1]


def _block_map(unit_k, threads, costs):
    """(cells, warps, order) of the block regime for a case given in threads
    a block: 9 or 17 cells a lane in turns over the cost models, the
    warps of `threads` up to the instantiation's most (1024 threads: 16
    warps of 9 cells or 18 of 17, nearly all of them past the band), at
    least as many as hold the band; the warps of a round in either
    order."""
    q = BAND_COSTS.index(costs)
    cells = lb.BLOCK_CELLS[q % 2]
    warps = min(threads // 32, lb.BLOCK_MAX_WARPS[cells])
    warps = max(warps, -(-(2 * unit_k + 1) // (32 * cells)))
    return cells, warps, (q // 2 + threads // 32) % 2


# The block regime (one pair a block of warps, the warp regime's lanes
# joined across warps by slots in shared memory; the cases the wide regime
# had when it kept the band in shared memory): band half-widths around the
# 16-codes-a-word steps; warps that lie wholly past the band, a band inside
# one warp, one that spans warps
@pytest.mark.parametrize("unit_k,max_m,threads", [
    (0, 20, 32), (4, 40, 32), (7, 40, 32), (8, 40, 64), (32, 70, 32),
    (64, 40, 96), (100, 30, 1024),
])
@pytest.mark.parametrize("costs", BAND_COSTS,
                         ids=["unit", "rdamerau", "affine", "affine_transpose"])
def test_band_rows_equal_plain_version_and_oracle(lib, unit_k, max_m, threads,
                                                  costs):
    rng = np.random.default_rng(31 * unit_k + max_m + costs[0])
    a_list, b_list = _band_pairs(rng, 40, max_m, unit_k)
    _band_check(lib, a_list, b_list, unit_k, max_m, costs, threads, 0, 0,
                block=_block_map(unit_k, threads, costs))


# The block regime at its warp edges: the band one cell past a warp (545:
# 2 warps of 17 cells, 289 and 577: 2 and 3 of 9) and one short of a warp
# (543, 287, 1,087: the last cell of the last warp is a ghost), with
# adjacent swaps on the diagonals of the warp edges, pairs at the band's
# edge (n - m == unit_k), m == 0 and NUL bytes, under the four cost
# models; the warps of a round in either order.  Few pairs and rows: the
# plain version's tensors stay under 32,768 elements.
BLOCK_EDGES = [(545, 17, 2), (543, 17, 1), (1087, 17, 2), (289, 9, 2),
               (287, 9, 1), (577, 9, 3)]


@pytest.mark.parametrize("W,cells,warps", BLOCK_EDGES,
                         ids=[f"W{w}-{n}x{c}" for w, c, n in BLOCK_EDGES])
def test_band_block_warp_edges_equal_plain_version(lib, W, cells, warps):
    unit_k = (W - 1) // 2
    rng = np.random.default_rng(W * 31 + cells)
    for q, costs in enumerate(BAND_COSTS):
        max_m = int(rng.integers(8, 13))
        a_list, b_list = _band_pairs(rng, 3, max_m, unit_k)
        a_e, b_e = cs.lane_edge_pairs(rng, unit_k, 32 * cells, max_m)
        _band_check(lib, a_list + a_e[:3], b_list + b_e[:3], unit_k, max_m,
                    costs, 0, 0, 0, oracle=False,
                    block=(cells, warps, q % 2))


LANE_CASES = cs.band_lane_cases()


# The warp regime: a group of lanes a pair, cells in registers.  Each case
# runs a batch that leaves part of its last warp empty and one of several
# warps, with pairs at the band's edge (n - m == unit_k), m == 0, NUL bytes
# (the pads are 0 too), adjacent swaps anywhere and swaps on the diagonals
# of the lane edges, under the four cost models.
@pytest.mark.parametrize("W,cells,lanes", LANE_CASES,
                         ids=[f"W{w}-{g}x{c}" for w, c, g in LANE_CASES])
def test_band_lanes_equal_plain_version_and_oracle(lib, W, cells, lanes):
    unit_k = (W - 1) // 2
    rng = np.random.default_rng(W * 97 + cells * 7 + lanes)
    per_warp = 32 // lanes
    for k, costs in enumerate(BAND_COSTS):
        max_m = int(rng.integers(12, 30))
        n_pairs = per_warp - 1 if k % 2 else 2 * per_warp + 1
        a_list, b_list = _band_pairs(rng, max(n_pairs, 2), max_m, unit_k)
        a_e, b_e = cs.lane_edge_pairs(rng, unit_k, cells, max_m)
        _band_check(lib, a_list + a_e, b_list + b_e, unit_k, max_m, costs,
                    32 * (1 + k % 2), cells, lanes, oracle=W < 200)


def test_band_rehearsal_refuses_what_the_launcher_refuses(lib):
    z = np.zeros(64, np.uint8)
    i0 = np.zeros(1, np.int32)
    out = np.zeros(1, np.int32)
    args = [z.ctypes.data, z.ctypes.data, i0.ctypes.data, i0.ctypes.data,
            out.ctypes.data, None, 1, 16, 25]
    # the block regime: 9 or 17 cells a lane, 1 to 16 or 18 warps that
    # hold the band (the band in shared memory is no longer taken)
    assert lib.ta_rehearse_band_block(*args, 4, 16, 1, 1, 0, 0, 0, 9, 1,
                                      0) == 0
    assert out[0] == 0
    assert lib.ta_rehearse_band(*args, 4, 16, 1, 1, 0, 0, 0, 32, 0,
                                0) == 1
    for cells, warps in ((9, 0), (5, 1), (9, 17), (17, 19)):
        assert lib.ta_rehearse_band_block(*args, 4, 16, 1, 1, 0, 0, 0,
                                          cells, warps, 0) == 1
    assert lib.ta_rehearse_band_block(*args, 8192, 16, 1, 1, 0, 0, 0, 17,
                                      18, 0) == 1  # 9,792 cells < 16,385
    assert lib.ta_rehearse_band_block(*args, 144, 16, 1, 1, 0, 0, 0, 9, 1,
                                      0) == 1  # 288 cells < W = 289
    # the warp regime: a known lane map that holds the band, <= 256
    # threads; no other regime behind it (cells 0 took the band in device
    # memory once)
    out[0] = -7
    assert lib.ta_rehearse_band(*args, 4, 16, 1, 1, 0, 0, 0, 64, 3,
                                8) == 0
    assert out[0] == 0
    for cells, lanes, threads in ((4, 8, 32), (3, 4, 32), (3, 64, 32),
                                  (3, 8, 512), (0, 0, 128), (0, 0, 1024)):
        assert lib.ta_rehearse_band(*args, 4, 16, 1, 1, 0, 0, 0, threads,
                                    cells, lanes) == 1
    assert lib.ta_rehearse_band(*args, 12, 16, 1, 1, 0, 0, 0, 32, 3,
                                8) == 1  # 24 cells < W = 25


def _cluster_check(lib, a_list, b_list, unit_k, max_m, costs, ctas, warps,
                   oracle, full=False):
    """K4's cluster regime, rehearsed at `ctas` CTAs of `warps` warps in
    both of the rehearsal's warp orders, against the plain version:
    distances, every code word of rows 1..m, and the walked streams; with
    `oracle`, distances and edit lists against the oracle wherever the
    costs stay inside the band.  `full`: the strips cover every band
    column (no rule right of column n + 2)."""
    B = len(a_list)
    ct = (costs[0], costs[1], costs[2], costs[3] or 0, costs[3] is not None)
    t = lb.prepare_band_tensors(a_list, b_list, unit_k, max_m, device="cpu")
    plain_d, plain_codes = bs.band_scan_distance(
        *t, unit_k=unit_k, costs_t=ct, trace_on=True)
    plain_seq, _ = bs.walk_packed_traceback(plain_codes, *t, unit_k=unit_k)
    arrs = [x.numpy() for x in t]
    rows, wpr = plain_codes.shape[1], plain_codes.shape[2]
    for order in (0, 1):
        out = np.full(B, -7, np.int32)
        codes = np.full((B, rows, wpr), 0x3C3C3C3C, np.int32)
        rc = lib.ta_rehearse_band_cluster(
            *[x.ctypes.data for x in arrs], out.ctypes.data, codes.ctypes.data,
            B, arrs[0].shape[1], arrs[1].shape[1], unit_k, rows, *ct[:4],
            int(ct[4]), ctas, warps, int(full), order)
        assert rc == 0
        assert np.array_equal(out, plain_d.numpy()), (costs, order)
        for p in range(B):
            mp = len(a_list[p])
            assert np.array_equal(codes[p, :mp],
                                  plain_codes[p, :mp].numpy()), (costs, p)
        seq, _ = bs.walk_packed_traceback(torch.from_numpy(codes), *t,
                                          unit_k=unit_k)
        assert torch.equal(seq, plain_seq)
    if oracle:
        kband = unit_k * ct[1] + ct[2]
        decoded = bs.decode_walked_batch(*bs.run_length_encode(plain_seq),
                                     [False] * B)
        for p, (a, b) in enumerate(zip(a_list, b_list)):
            ref = levenshtein_naive_k_with_opts(a, b, kband, True,
                                                EditCosts(*costs))
            if ref is not None:
                assert int(plain_d[p]) == ref[0] and decoded[p] == ref[1]


# K4's cluster regime (band_cluster_kernel): 1, 2, 3 and 8 CTAs a cluster
# (the widest the plan takes) of 1 or 2 warps; the longest b fills its last
# lane to column n + 2 (the cluster's columns exactly) or stops a column
# short; transpositions across lane, warp and CTA edges
# (`cs.cluster_edge_pairs`); m = 0; every row phase of the code words'
# offset (i mod 16); narrow bands (the rows past the band leave columns
# behind) and bands wider than the matrix.  (ctas, warps, unit_k, rows,
# longest b, random pairs: the first two are the empty ones; at 8 CTAs
# only those, so that the plain scan's [pairs, W] rows stay under one
# parallel grain of PyTorch's CPU ops, which the test workers' threads
# would contend for)
CLUSTER_MAPS = [(1, 1, 300, 220, 509, 4), (2, 1, 40, 1000, 1021, 4),
                (3, 1, 600, 1000, 1533, 4), (8, 1, 3000, 1100, 4093, 2),
                (2, 2, 1100, 1000, 2045, 4)]


@pytest.mark.parametrize("ctas,warps,unit_k,max_m,max_n,n_pairs",
                         CLUSTER_MAPS,
                         ids=[f"{c}x{w}-uk{u}" for c, w, u, _, _, _ in
                              CLUSTER_MAPS])
@pytest.mark.parametrize("costs", BAND_COSTS,
                         ids=["unit", "rdamerau", "affine", "affine_transpose"])
def test_band_cluster_equals_plain_version(lib, ctas, warps, unit_k, max_m,
                                           max_n, n_pairs, costs):
    rng = np.random.default_rng(ctas * 1000 + warps * 100 + costs[0])
    a_list, b_list = cs.cluster_pairs(rng, n_pairs, max_m, max_n, unit_k)
    a_e, b_e = cs.cluster_edge_pairs(rng, unit_k, max_m, max_n)
    _cluster_check(lib, a_list + a_e, b_list + b_e, unit_k, max_m, costs,
                   ctas, warps, oracle=max_n < 600)


@pytest.mark.parametrize("check", cs.CLUSTER_CHECKS,
                         ids=[f"{c}x{w}-uk{u}" for u, _, _, c, w, _ in
                              cs.CLUSTER_CHECKS])
def test_cluster_checks_fill_their_clusters(check):
    """Each of K4's cluster checks on the card: pairs inside the band and
    the kernel's contract, its longest b at the cluster's edge or under it
    (n + 3 <= 512 x CTAs x warps), transpositions ending on lanes' first
    two columns, and a plan the wrapper takes for them."""
    unit_k, max_m, max_n, ctas, warps, n_pairs = check
    rng = np.random.default_rng(11)
    a_list, b_list = cs.cluster_pairs(rng, n_pairs, max_m, max_n, unit_k)
    a_e, b_e = cs.cluster_edge_pairs(rng, unit_k, max_m, max_n)
    for a, b in zip(a_list + a_e, b_list + b_e):
        assert len(a) <= len(b) <= min(len(a) + unit_k, max_n)
        assert len(a) <= max_m
    assert max(len(b) for b in b_list + b_e) == max_n
    assert max_n + 3 <= 512 * ctas * warps
    assert len(a_list[0]) == len(b_list[0]) == len(a_list[1]) == 0
    a, b = a_e[0], b_e[0]  # no shift: swapped at q = 14, 15 (mod 16)
    diff = np.flatnonzero(a != b)
    assert diff.size and set((diff % 16).tolist()) <= {14, 15}
    plan = cs.cluster_plan(max_m, unit_k, ctas, warps)
    lb._check_plan(plan, 2 * unit_k + 1)
    assert plan["regime"] == "wide_cluster"
    assert plan["ctas_per_pair"] * plan["threads"] * 16 >= max_n + 3


def test_band_cluster_rehearsal_refuses_what_the_launcher_refuses(lib):
    z = np.zeros(64, np.uint8)
    i0 = np.zeros(1, np.int32)
    out = np.full(1, -7, np.int32)
    codes = np.zeros(4, np.int32)
    args = [z.ctypes.data, z.ctypes.data, i0.ctypes.data, i0.ctypes.data,
            out.ctypes.data, codes.ctypes.data, 1, 16, 25, 4, 1, 1, 1, 0, 0,
            0]
    assert lib.ta_rehearse_band_cluster(*args, 1, 1, 0, 0) == 0
    assert out[0] == 0
    for ctas, warps, full in ((0, 1, 0), (9, 1, 0), (1, 0, 0), (1, 21, 0),
                              (1, 1, 2), (1, 1, -1)):
        assert lib.ta_rehearse_band_cluster(*args, ctas, warps, full,
                                            0) == 1
    big = list(args)
    big[9] = lb.MAX_TRACE_UNIT_K + 1  # past the widest traced band
    assert lib.ta_rehearse_band_cluster(*big, 1, 1, 0, 0) == 1
    args[5] = None  # no codes: the regime is traced only
    assert lib.ta_rehearse_band_cluster(*args, 1, 1, 0, 0) == 1


def _ring_pairs(rng, n_pairs, m_lo, m_hi, unit_k, max_n):
    """ACGT pairs for the ring's cases: a of m_lo .. m_hi bytes, b a copy
    with substitutions and adjacent swaps, grown by insertions to between
    len(a) and min(len(a) + unit_k, max_n) bytes, the first at that top."""
    a_list, b_list = [], []
    for p in range(n_pairs):
        m = int(rng.integers(m_lo, m_hi + 1))
        a = cs.ACGT[rng.integers(0, 4, m)]
        b = a.copy()
        b[rng.integers(0, m, m // 30 + 1)] = cs.ACGT[rng.integers(0, 4)]
        for q in rng.integers(0, m - 1, m // 40 + 2).tolist():
            b[q], b[q + 1] = int(b[q + 1]), int(b[q])
        top = min(m + unit_k, max_n)
        n = top if p == 0 else int(rng.integers(m, top + 1))
        b = np.insert(b, rng.integers(0, m + 1, n - m),
                      cs.ACGT[rng.integers(0, 4, n - m)])
        a_list.append(a)
        b_list.append(b)
    return a_list, b_list


# K4's cluster regime as a ring of strips (512 columns each) over fewer
# warps than strips, forced onto small bands so that the plain scan's
# tensors stay under 32,768 elements: (case, CTAs, warps a CTA, unit_k,
# rows, longest b, pairs, full_band, cost model).  `wrap`: 5 strips on 2
# warps, the wrap taken twice, and at band 17 a strip's rows overlap only
# its neighbours' (strips two apart run disjoint rows); `one_warp`: 3
# strips on one warp, every hand-over through the wrap; `as_many`: 3
# strips on 3 warps, the longest b's last lane at column n + 2; `swaps`:
# 4 strips on 3 CTAs of one warp, transpositions on the first two columns
# of lanes (so across lane, warp, CTA and wrap edges) and on the band's
# right edge at each strip's first column (`cs.ring_edge_pair`); `m0`:
# every a empty (only the strips' last steps run), b up to unit_k = 1,100
# bytes (3 strips); `mixed`: pairs of 1 to 4 strips in one batch on 2 CTAs;
# `full`: the strips cover every band column (the path past the INF rule)
# on pairs whose band reaches a strip more than n + 2 does; `wide`: a band
# of 1,201 cells (wider than a strip, as the plan's are) over 2 strips on
# one warp.
RING_CASES = [
    ("wrap", 1, 2, 8, 2080, 2100, 2, False, 0),
    ("one_warp", 1, 1, 24, 1400, 1420, 2, False, 1),
    ("as_many", 1, 3, 16, 1520, 1533, 2, False, 2),
    ("swaps", 3, 1, 12, 1590, 1600, 2, False, 3),
    ("m0", 1, 1, 1100, 0, 1100, 8, False, 0),
    ("mixed", 2, 1, 20, 1700, 1710, 3, False, 3),
    ("full", 1, 1, 250, 300, 330, 3, True, 1),
    ("wide", 1, 1, 600, 200, 800, 2, False, 2),
]


@pytest.mark.parametrize("case", RING_CASES, ids=[c[0] for c in RING_CASES])
def test_band_cluster_ring_equals_plain_version_and_oracle(lib, case):
    name, ctas, warps, unit_k, max_m, max_n, n_pairs, full, q = case
    costs = BAND_COSTS[q]
    rng = np.random.default_rng(sum(map(ord, name)) + 97 * unit_k)
    if name in ("m0",):
        a_list = [np.empty(0, np.uint8)] * n_pairs
        b_list = [cs.ACGT[rng.integers(0, 4, n)] for n in
                  (0, 1, 510, 511, 512, 1021, 1022, max_n)]
    elif name in ("full", "wide"):
        a_list, b_list = _ring_pairs(rng, n_pairs, max_m - 30, max_m,
                                     unit_k, max_n)
    else:
        a_list, b_list = cs.cluster_pairs(rng, n_pairs, max_m, max_n,
                                          unit_k)
        a_e, b_e = cs.cluster_edge_pairs(rng, unit_k, max_m, max_n)
        if name == "mixed":  # pairs of 2 and 3 strips, and the longest
            for m in (700, 1200):
                a_m, b_m = _ring_pairs(rng, 1, m - 10, m, unit_k, m + 20)
                a_list, b_list = a_list + a_m, b_list + b_m
            a_e, b_e = a_e[-1:], b_e[-1:]
        a_list, b_list = a_list + a_e, b_list + b_e
        if name == "swaps":
            a_s, b_s = cs.ring_edge_pair(rng, max_n - unit_k - 8, unit_k)
            a_list, b_list = a_list + [a_s], b_list + [b_s]
    strips = [-(-(len(b) + 3) // 512) for b in b_list]
    if full:  # the band reaches one strip past n + 2
        assert all(-(-(len(a) + unit_k + 1) // 512) > s
                   for a, s in zip(a_list, strips))
    assert max(strips) > ctas * warps or name in ("as_many", "full")
    if name == "mixed":
        assert sorted(set(strips)) == [1, 2, 3, 4]
    _cluster_check(lib, a_list, b_list, unit_k, max(max_m, 1), costs, ctas,
                   warps, oracle=name not in ("m0",), full=full)


# K10's body on its edges, at the plan's launch shape and at
# chip_smoke.WALK_CHECK_PLANS' (the many-pairs plan, one lane staging
# two-row tiles of one-word windows, a warp a pair with three-row tiles,
# 64-row tiles of 16 words, 16 lanes a pair):
# the walk edge pairs (cells 0, 15, 16, 31, 32, W - 1, a transposition
# last, m = 0), the longest walk the bound allows, random codes whose walks
# leave the matrix, gap runs that leave the window sideways and adjacent
# swaps across every tile edge (`walk_gap_pairs`), bands 1, 17 and 65 with
# m = 0 pairs, and band 20,129 (the `past_plan` cell's) at a cut of 40
# rows with a 3,000-step gap run.
@pytest.mark.parametrize("case", ["edges", "longest", "random", "gap_runs",
                                  "bands", "band_20129"])
def test_trace_walk_body_equals_plain_version(lib, case):
    rng = np.random.default_rng(len(case))
    unit_k, max_m = 16, 80
    batches = []
    if case == "random":
        B, W = 45, 2 * unit_k + 1
        m = rng.integers(0, max_m + 1, B).astype(np.int32)
        t = (torch.from_numpy(rng.integers(65, 69, (B, max_m))
                              .astype(np.uint8)),
             torch.from_numpy(rng.integers(65, 69, (B, max_m + W))
                              .astype(np.uint8)),
             torch.from_numpy(m),
             torch.from_numpy((m + rng.integers(0, unit_k + 1, B))
                              .astype(np.int32)))
        batches.append((torch.from_numpy(rng.integers(
            -(1 << 31), 1 << 31, (B, max_m, bs.code_words(W)),
            dtype=np.int64).astype(np.int32)), t, unit_k))
    else:
        costs = (1, 1, 0, 1, True)
        if case == "edges":
            a_list, b_list = cs.walk_edge_pairs(rng, unit_k, max_m)
            cut = [(a_list * 5, b_list * 5, unit_k, max_m)]  # 35 pairs
        elif case == "longest":
            a, b = cs.longest_walk_pair(unit_k, max_m)
            cut = [([a] * 33, [b] * 33, unit_k, max_m)]
            costs = (3, 1, 0, 0, False)
        elif case == "gap_runs":
            a_list, b_list = cs.walk_gap_pairs(rng, 600, 150)
            cut = [(a_list * 2, b_list * 2, 160, 750)]
        elif case == "bands":
            cut = [(*cs.band_cases(rng, 9, 40, uk), uk, 40)
                   for uk in (0, 8, 32)]
        else:
            a = cs.ACGT[rng.integers(0, 4, 40)]
            b = np.insert(a, 17, cs.ACGT[rng.integers(0, 4, 3000)])
            b[30], b[31] = int(b[31]), int(b[30])
            cut = [([a, np.empty(0, np.uint8)], [b, b[:100]], 10_064, 48)]
        for a_list, b_list, uk, mm in cut:
            t = lb.prepare_band_tensors(a_list, b_list, uk, mm, device="cpu")
            _, codes = bs.band_scan_distance(*t, unit_k=uk, costs_t=costs,
                                             trace_on=True)
            batches.append((codes, t, uk))
    for codes, t, uk in batches:
        plain = ttw.trace_walk_plain(codes, *t, unit_k=uk)
        for shape in (None, *(p[:3] for p in cs.WALK_CHECK_PLANS)):
            got = _rehearse_walk(lib, codes.numpy(), t, uk, shape)
            assert _same_runs(got, plain), (case, uk, shape)
    if case == "longest":
        steps = ttw.walk_steps(max_m, unit_k)
        assert int((plain[0][:int(plain[1][0])] >> 3).sum()) == steps - 1
    if case == "band_20129":
        assert int((plain[0] >> 3).max()) > 2000  # one long gap run


def test_trace_walk_rehearsal_refuses_what_the_launcher_refuses(lib):
    t = lb.prepare_band_tensors([np.zeros(3, np.uint8)],
                                [np.zeros(5, np.uint8)], 4, 8, device="cpu")
    _, codes = bs.band_scan_distance(*t, unit_k=4, costs_t=(1, 1, 0, 0,
                                                             False),
                                     trace_on=True)
    for shape in ((8, 32, 8), (1, 2, 1), (32, 1024, 256)):
        assert _rehearse_walk(lib, codes.numpy(), t, 4, shape)[1].tolist() \
            == [2]
    arrs = [x.numpy() for x in t]
    c = codes.numpy()
    buf = np.zeros(64, np.int32)
    for shape in ((3, 32, 8), (0, 32, 8), (64, 32, 8), (8, 1, 8),
                  (8, 32, 0), (8, 32, 257)):
        assert lib.ta_rehearse_trace_walk(
            c.ctypes.data, *[x.ctypes.data for x in arrs], buf.ctypes.data,
            buf.ctypes.data, 1, 8, 1, 8, 17, 4, 37, *shape) == 1, shape
    # a b row too short for the band, and 2^28 steps
    assert lib.ta_rehearse_trace_walk(
        c.ctypes.data, *[x.ctypes.data for x in arrs], buf.ctypes.data,
        buf.ctypes.data, 1, 8, 1, 8, 15, 4, 37, 8, 32, 8) == 1
    assert lib.ta_rehearse_trace_walk(
        c.ctypes.data, *[x.ctypes.data for x in arrs], buf.ctypes.data,
        buf.ctypes.data, 1, 8, 1, 8, 17, 4, 1 << 28, 8, 32, 8) == 1


def _blocked_distance_rehearsal(lib, t, wpt, damerau):
    """The K5 body over prepared tensors at `wpt` words a lane (the plan
    would pick one; every word count the kernel is built for is run)."""
    a, b, m, n = (x.numpy() for x in t)
    codes, rows = mc.alphabet_codes(t[0], t[2])
    codes = codes.numpy()
    sstride = -(-max(int(n.max()), 1) // 16) * 16
    scratch = np.zeros((len(m), sstride), np.uint8)
    out = np.full(len(m), -7, np.int32)
    rc = lib.ta_rehearse_blocked_distance(
        a.ctypes.data, b.ctypes.data, m.ctypes.data, n.ctypes.data,
        codes.ctypes.data, rows, wpt, out.ctypes.data, len(m), a.shape[1],
        b.shape[1], scratch.ctypes.data, sstride, int(damerau))
    return rc, out


@pytest.mark.parametrize("damerau", [False, True], ids=["unit", "rdamerau"])
def test_blocked_distance_body_equals_plain_version_and_native(lib, damerau):
    """Needle lengths on both sides of the word (32 chars), of a lane's
    words at every built word count (32 * {1, 2, 3, 4, 6, 8, 12, 20}) and
    of a strip at one word a lane (1024), edited copies with adjacent
    swaps, NUL bytes, an empty a, and one full-byte needle (its 257-row
    table allows at most 6 words a lane: the rest run without it)."""
    rng = np.random.default_rng(77 + damerau)
    lengths = [1, 31, 32, 33, 63, 65, 95, 97, 127, 129, 191, 193, 255, 257,
               383, 385, 639, 641, 1023, 1024, 1025, 1100]
    a_list, b_list = [np.empty(0, np.uint8)], [
        rng.integers(0, 4, 9).astype(np.uint8)]
    for ln in lengths:
        a = rng.integers(0, 4, ln).astype(np.uint8)
        a[rng.integers(0, ln, 2)] = 0  # NUL chars: pads are 0 too
        b = a.copy()
        b[rng.integers(0, ln, ln // 20 + 1)] = 1
        for q in rng.integers(0, max(ln - 1, 1), ln // 40 if ln > 1 else 0):
            b[q], b[q + 1] = b[q + 1], b[q]
        b = np.insert(b, rng.integers(0, ln + 1, ln // 30 + 1), 3)
        a_list.append(a)
        b_list.append(b)
    full = rng.permutation(256).astype(np.uint8)  # every byte, NUL included
    a_list.append(np.tile(full, 5))
    b_list.append(np.concatenate([np.tile(full, 5)[7:], full[:40]]))
    t = mc.prepare_blocked_distance_inputs(a_list, b_list, device="cpu")
    plain = mc.blocked_distance_plain(*t, damerau=damerau).numpy()
    exp = (scalar_banded_batch_native(a_list, b_list, 1 << 30,
                                      RDAMERAU_COSTS) if damerau
           else myers_distance_batch_native(a_list, b_list, 1 << 30))
    assert np.array_equal(np.where(t[2].numpy() == 0, t[3].numpy(), plain),
                          exp)
    for wpt in (1, 2, 3, 4, 6):
        rc, out = _blocked_distance_rehearsal(lib, t, wpt, damerau)
        assert rc == 0 and np.array_equal(out, plain), wpt
    rc, _ = _blocked_distance_rehearsal(lib, t, 8, damerau)
    assert rc == 1  # 257 rows x 8 words a lane pass a block's shared memory
    t4 = [x[:-1] for x in t]  # without the full-byte needle
    for wpt in (8, 12, 20):
        rc, out = _blocked_distance_rehearsal(lib, t4, wpt, damerau)
        assert rc == 0 and np.array_equal(out, plain[:-1]), wpt


def _blocked_search_rehearsal(lib, hay, needles, m, plan, own, halo,
                              anchored, damerau):
    """The K6 body over one launch at the lane map `plan` (words a lane,
    lanes a segment, warps a block), uint8 hay [it] and needles [num, m];
    returns rc and the rows [num, it + 1] (pad columns checked unwritten)."""
    it, num = len(hay), needles.shape[0]
    codes, rows = mc.alphabet_codes(torch.from_numpy(needles),
                                    torch.full((num,), m))
    codes = codes.numpy()
    nseg = seg_count(it, own)
    stride = -(-(it + 1) // 4) * 4
    sstride = -(-(halo + own + 15) // 16) * 16
    out = np.full((num, stride), -7, np.int32)
    scratch = np.zeros((num * nseg, sstride), np.uint8)
    rc = lib.ta_rehearse_blocked_search(
        hay.ctypes.data, it, needles.ctypes.data, num, m, codes.ctypes.data,
        rows, plan[0], plan[1], plan[2], own, halo, nseg, int(anchored),
        int(damerau), out.ctypes.data, stride, scratch.ctypes.data, sstride)
    assert (out[:, it + 1:] == -7).all()  # pad columns stay unwritten
    return rc, out[:, : it + 1]


@pytest.mark.parametrize("anchored", [False, True],
                         ids=["unanchored", "anchored"])
@pytest.mark.parametrize("damerau", [False, True], ids=["unit", "rdamerau"])
def test_blocked_search_body_equals_plain_version_and_native(lib, damerau,
                                                             anchored):
    """Two 2100-char needles in one call, one of them over all 256 bytes
    (NUL included), against a haystack that holds NUL bytes and a planted
    copy with an adjacent swap: three strips at 32 lanes x 1 word, two at
    32 x 2, at 16 x 3 (2 warps a block) and at 8 x 6 (4 warps: the block's
    last warps hold no segment); unanchored over segments of an
    owned length that is not a multiple of 4 (the scalar edges of the
    four-column stores)."""
    rng = np.random.default_rng(5 + 2 * damerau + anchored)
    costs = RDAMERAU_COSTS if damerau else LEVENSHTEIN_COSTS
    m, n, k = 2100, 2600, 30
    needles = np.stack([rng.integers(0, 256, m).astype(np.uint8),
                        rng.integers(0, 4, m).astype(np.uint8)])
    needles[0, rng.integers(0, m, 3)] = 0
    hay = rng.integers(0, 4, n).astype(np.uint8)
    hay[[0, 5, n - 1]] = 0
    pos = 0 if anchored else 300
    hay[pos:pos + m] = needles[1]
    hay[pos + 50], hay[pos + 51] = hay[pos + 51], hay[pos + 50]
    if anchored:
        it, halo = min(m + k, n), 0
        own = it
    else:
        it, halo, own = n, window_span(m, k, 1, 0), 333
    h = hay[:it].copy()
    plain = ms.myers_search_plain(
        torch.from_numpy(h), torch.from_numpy(needles), own_len=own,
        halo=halo, anchored=anchored, damerau=damerau).numpy()
    for plan in ((1, 32, 1), (2, 32, 1), (3, 16, 2), (6, 8, 4)):
        rc, out = _blocked_search_rehearsal(lib, h, needles, m, plan, own,
                                            halo, anchored, damerau)
        assert rc == 0
        assert np.array_equal(out, plain), plan
    for i in range(2):
        ends, ks, _ = search_all_native(needles[i], hay, k, costs,
                                        anchored=anchored)
        got = {j: int(plain[i, j]) for j in range(it + 1)
               if plain[i, j] <= k}
        assert got == dict(zip(ends.tolist(), ks.tolist()))
    assert int(plain[1].min()) <= 2  # the planted copy


BLOCKED_MAPS = cs.blocked_map_cases()


@pytest.mark.parametrize("wpt", mc.WPT_CHOICES,
                         ids=[f"w{w}" for w in mc.WPT_CHOICES])
def test_blocked_lane_maps_equal_plain_version(lib, wpt):
    """Every lane map of K6 at `wpt` words a lane (4 to 32 lanes a
    segment), its lanes in turn and its warps in order, at the map's edges
    (chip_smoke.blocked_map_cases: a group's share one word short, a strip
    one word over, a lane's share one word under and over): swaps across a
    word, a lane and a strip edge, segments that leave a block's last warp
    or a warp's last groups empty, unit and rDamerau, every fifth case
    anchored; exact against the plain version."""
    rng = np.random.default_rng(300 + wpt)
    n = cs.BLOCKED_MAP_BYTES
    for q, (w, lanes, m) in enumerate(BLOCKED_MAPS):
        if w != wpt:
            continue
        needles, hay = cs.blocked_map_input(rng, m, w, lanes, n)
        anchored, damerau = q % 5 == 4, q % 2 == 1
        own = n if anchored else -(-n // cs.BLOCKED_MAP_SEGS)
        halo = 0 if anchored else cs.BLOCKED_MAP_HALO
        plain = ms.myers_search_plain(
            torch.from_numpy(hay), torch.from_numpy(needles), own_len=own,
            halo=halo, anchored=anchored, damerau=damerau).numpy()
        rc, out = _blocked_search_rehearsal(
            lib, hay, needles, m, (w, lanes, cs.BLOCKED_MAP_WARPS), own,
            halo, anchored, damerau)
        assert rc == 0
        assert np.array_equal(out, plain), (lanes, w, m, anchored, damerau)


# the general-cost kernels: unit, rDamerau, affine, affine with weighted
# transpositions, and a mismatch cheaper than a gap with a free gap start
GENERAL_COSTS = [(1, 1, 0, None), (1, 1, 0, 1), (2, 1, 2, None),
                 (3, 2, 1, 2), (1, 2, 0, None)]


def _gct(c):
    costs = EditCosts(*c)
    return (costs.mismatch_cost, costs.gap_cost, costs.start_gap_cost,
            costs.transpose_cost_or_zero, costs.allow_transpose)


def _general_search_case(rng, m, n):
    """An ACGT-coded haystack starting with NUL bytes and a needle holding
    one, with two planted copies (an adjacent swap in each)."""
    needle = rng.integers(0, 4, m).astype(np.uint8)
    needle[m // 2] = 0
    hay = rng.integers(0, 4, n).astype(np.uint8)
    hay[:2] = 0
    for pos in (0, n // 2):
        copy = needle.copy()
        if m > 3:
            copy[1], copy[2] = copy[2], copy[1]
        hay[pos: pos + m] = copy[: n - pos]
    return needle, hay


def _geometry(m, k, ct, n, anchored, own):
    if anchored:
        it = min(m + max(0, k - ct[2]) // ct[1], n)
        return it, 0, max(it, 1)
    return n, min(window_span(m, k, ct[1], ct[2]), n), own


def _sd_rehearsal(lib, h, needle, own, halo, anchored, ct, plan):
    """The K7 body over one launch at the lane map `plan` (rows a lane,
    lanes a segment, warps a block); (rc, dist, length)."""
    it, m = len(h), len(needle)
    od = np.full(it + 1, -7, np.int32)
    ol = np.full(it + 1, -7, np.int32)
    rc = lib.ta_rehearse_search_diag(
        h.ctypes.data, it, needle.ctypes.data, m, own, halo,
        seg_count(it, own), int(anchored), *ct[:4], int(ct[4]), *plan,
        od.ctypes.data, ol.ctypes.data)
    return rc, od, ol


def _sd_equal(od, ol, pd, pl):
    """Distances equal everywhere, lengths where the distance is finite."""
    fin = pd < bs.INF
    return np.array_equal(od, pd) and np.array_equal(ol[fin], pl[fin])


@pytest.mark.parametrize("m,c,anchored", [
    (24, 2, False), (33, 1, False), (70, 3, True), (130, 4, False),
    (512, 0, False)],
    ids=["m24_affine", "m33_rdamerau", "m70_transpose_anchored",
         "m130_cheap_mismatch", "m512_unit"])
def test_search_diag_body_equals_plain_version_and_oracle(lib, m, c,
                                                          anchored):
    """K7's lanes in turn at the plan's map (4 lanes x 6 rows, 4 x 12, 8 x
    12, 16 x 12, 32 x 16; 8 warps a block), ragged segments (their tails
    need single stores), NUL bytes, and k at the end-0 candidate's cost,
    so position 0 is a hit."""
    rng = np.random.default_rng(900 + m)
    ct = _gct(GENERAL_COSTS[c])
    needle, hay = _general_search_case(rng, m, 700)
    k = m * ct[1] + ct[2]
    it, halo, own = _geometry(m, k, ct, len(hay), anchored, 131)
    h = hay[:it].copy()
    pd, pl = sd.search_diag_plain(torch.from_numpy(h),
                                  torch.from_numpy(needle), own_len=own,
                                  halo=halo, costs_t=ct, anchored=anchored)
    pl_ = sd.diag_plan(m)
    rc, od, ol = _sd_rehearsal(lib, h, needle, own, halo, anchored, ct,
                               (pl_["rows_per_lane"], pl_["lanes"],
                                pl_["warps"]))
    assert rc == 0
    pd, pl = pd.numpy(), pl.numpy()
    assert _sd_equal(od, ol, pd, pl)
    costs = EditCosts(*GENERAL_COSTS[c])
    exp = levenshtein_search_naive_with_opts(needle, hay, k, SearchType.All,
                                             costs, anchored)
    got = [(int(p - pl[p]), int(p), int(pd[p]))
           for p in np.flatnonzero(pd <= k)]
    assert got == [(mt.start, mt.end, mt.k) for mt in exp]
    assert got[0][1] == 0  # the end-0 candidate


DIAG_MAPS = cs.diag_map_cases()


@pytest.mark.parametrize("rows", sd.ROW_CHOICES,
                         ids=[f"r{r}" for r in sd.ROW_CHOICES])
def test_search_diag_lane_maps_equal_plain_version(lib, rows):
    """Every lane map of K7 at `rows` rows a lane (4 to 32 lanes a
    segment), its lanes in turn and its warps in order, at the map's edges
    (chip_smoke.diag_map_cases: the top lane full or holding one row, a
    lane's share one row under and over): transpositions across the first
    lane edge and the top lane's, segments that leave a block's last warp
    or a warp's last groups empty, the four cost models in turn, every
    fifth case anchored; exact against the plain version."""
    rng = np.random.default_rng(400 + rows)
    n = cs.DIAG_MAP_BYTES
    for q, (r, lanes, m) in enumerate(DIAG_MAPS):
        if r != rows:
            continue
        hay, needle = cs.diag_map_input(rng, m, r, lanes, n)
        ct = _gct(cs.FUZZ_COSTS[q % 4])
        k = m * ct[1] + ct[2]
        anchored = q % 5 == 4
        if anchored:
            it = min(m + max(0, k - ct[2]) // ct[1], n)
            own, halo = it, 0
        else:
            it, own = n, -(-n // cs.DIAG_MAP_SEGS)
            halo = window_span(m, k, ct[1], ct[2])
        h = hay[:it].copy()
        pd, pl = sd.search_diag_plain(torch.from_numpy(h),
                                      torch.from_numpy(needle), own_len=own,
                                      halo=halo, costs_t=ct,
                                      anchored=anchored)
        rc, od, ol = _sd_rehearsal(lib, h, needle, own, halo, anchored, ct,
                                   (r, lanes, cs.DIAG_MAP_WARPS))
        assert rc == 0
        assert _sd_equal(od, ol, pd.numpy(), pl.numpy()), (lanes, r, m, q)


# K8 / K9 launch shapes rehearsed: (threads, columns a lane), so 1, 2 and 3
# warps and 4, 8 and (K9 only) 16 columns a lane; strips of 256 to 512
SEARCH_SHAPES = [(32, 8), (64, 4), (96, 4), (64, 8)]
SEARCH_SHAPE_IDS = ["w1_c8", "w2_c4", "w3_c4", "w2_c8"]
DIST_SHAPES = [(32, 16), (64, 4), (96, 4), (64, 8)]
DIST_SHAPE_IDS = ["w1_c16", "w2_c4", "w3_c4", "w2_c8"]


def _swap_copy(needle):
    copy = needle.copy()
    copy[1], copy[2] = copy[2], copy[1]
    return copy


def _boundary_columns(threads, cols):
    """Columns (1-based, from the first column a block reads) whose
    transposition reads D[i-2][j-2] across a lane boundary (j at a lane's
    first column), across a warp boundary (a warp's first and second
    columns) and across the first strip boundary."""
    warp, strip = 32 * cols, threads * cols
    return [5 * cols + 1, warp + 1, warp + 2, strip + 1, strip + 2]


def _plant_boundary_swaps(hay, needle, col0s, cols_list):
    """Copies of the needle with its chars 1 and 2 swapped, the swap's
    transposition (row 3) at column j of a segment's text: at column c of
    the segment starting at col0, for (col0, c) in turn, where the copy
    overlaps none planted before (the two of _general_search_case
    included)."""
    m, n = len(needle), len(hay)
    taken = [(0, m), (n // 2, n // 2 + m)]
    copy = _swap_copy(needle)
    for col0, col in zip(col0s, cols_list):
        p = col0 + col - 3
        if p < 0 or p + m > n or any(p < e and s < p + m for s, e in taken):
            continue
        hay[p: p + m] = copy
        taken.append((p, p + m))


@pytest.mark.parametrize("threads,cols", SEARCH_SHAPES,
                         ids=SEARCH_SHAPE_IDS)
@pytest.mark.parametrize("m,c,anchored,selected", [
    (5, 0, False, False), (40, 3, False, False), (40, 1, False, True),
    (300, 2, True, False)],
    ids=["m5_unit", "m40_transpose", "m40_rdamerau_selected",
         "m300_affine_anchored"])
def test_flat_search_body_equals_plain_version_and_oracle(lib, m, c,
                                                          anchored,
                                                          selected, threads,
                                                          cols):
    """K8's warps in wavefront order and their lanes in turn, at several
    warps and columns a lane: every segment (401 owned columns, no multiple
    of a strip) spans strips, so the edges of every row (its D and length at
    a strip's last two columns and the prefix) cross strip boundaries;
    planted copies put a transposition across a lane, a warp and a strip
    boundary; a run over a selection of segments; NUL bytes."""
    rng = np.random.default_rng(950 + m)
    ct = _gct(GENERAL_COSTS[c])
    needle, hay = _general_search_case(rng, m, 1500)
    k = max(2, m // 8) * ct[0]
    it, halo, own = _geometry(m, k, ct, len(hay), anchored, 401)
    if not anchored:  # one boundary column in each of segments 1, 2, ...
        bc = _boundary_columns(threads, cols)
        _plant_boundary_swaps(hay, needle,
                              [s * own - halo for s in range(1, 1 + len(bc))],
                              bc)
    h = hay[:it].copy()
    nseg = seg_count(it, own)
    segs = (np.arange(1, nseg, 2) if selected else np.arange(nseg)).astype(
        np.int64)
    pd, pl = sf.flat_search_plain(
        torch.from_numpy(h), torch.from_numpy(needle), own_len=own,
        halo=halo, costs_t=ct, anchored=anchored,
        segments=torch.from_numpy(segs))
    od = np.full((len(segs), own), -7, np.int32)
    ol = np.full((len(segs), own), -7, np.int32)
    edges = np.zeros((len(segs), m + 2, 8), np.int32)
    rc = lib.ta_rehearse_flat_search(
        h.ctypes.data, it, needle.ctypes.data, m, own, halo,
        segs.ctypes.data, len(segs), int(anchored), *ct[:4], int(ct[4]),
        od.ctypes.data, ol.ctypes.data, edges.ctypes.data, threads, cols)
    assert rc == 0
    pd, pl = pd.numpy(), pl.numpy()
    assert np.array_equal(od, pd)
    fin = pd < bs.INF
    assert np.array_equal(ol[fin], pl[fin])
    if selected:
        return
    costs = EditCosts(*GENERAL_COSTS[c])
    exp = levenshtein_search_naive_with_opts(needle, hay, k, SearchType.All,
                                             costs, anchored)
    flat = pd.reshape(-1)
    got = [(int(p + 1 - pl.reshape(-1)[p]), int(p + 1), int(flat[p]))
           for p in np.flatnonzero(flat <= k)]
    assert got == [(mt.start, mt.end, mt.k) for mt in exp if mt.end > 0]
    assert any(mt.end == len(hay) // 2 + m for mt in exp) or anchored
    if m == 40:  # the copies across the boundaries are found, swap and all
        ends = {mt.end: mt.k for mt in exp}
        swap_cost = ct[3] if ct[4] else 2 * ct[0]
        for s, col in enumerate(_boundary_columns(threads, cols), 1):
            p = s * own - halo + col - 3
            if np.array_equal(hay[p: p + m], _swap_copy(needle)):
                assert ends.get(p + m, k + 1) <= swap_cost


def _flat_distance_rehearsal(lib, t, ct, unit_k, threads, cols):
    a, b, m, n = (x.numpy() for x in t)
    out = np.full(len(m), -7, np.int32)
    edges = np.zeros((len(m), a.shape[1] + 2, 4), np.int32)
    rc = lib.ta_rehearse_flat_distance(
        a.ctypes.data, b.ctypes.data, m.ctypes.data, n.ctypes.data, len(m),
        a.shape[1], b.shape[1], -1 if unit_k is None else unit_k, *ct[:4],
        int(ct[4]), out.ctypes.data, edges.ctypes.data, threads, cols)
    assert rc == 0
    return out


@pytest.mark.parametrize("threads,cols", DIST_SHAPES, ids=DIST_SHAPE_IDS)
@pytest.mark.parametrize("c", range(4), ids=["unit", "rdamerau", "affine",
                                              "affine_transpose"])
def test_flat_distance_body_equals_plain_version_and_native(lib, c, threads,
                                                            cols):
    """K9's warps in wavefront order and their lanes in turn, at several
    warps and columns a lane: pairs of up to 700 bytes (two to three
    strips, most no multiple of one), empty strings and NUL bytes, two
    pairs whose adjacent swaps put a transposition across a lane, a warp
    and a strip boundary, over the full matrix and banded (rows entering
    and leaving each strip's window)."""
    rng = np.random.default_rng(990 + c)
    costs = EditCosts(*GENERAL_COSTS[c])
    ct = _gct(GENERAL_COSTS[c])
    a_list, b_list = [np.empty(0, np.uint8), b"abc"], [b"xyz", b""]
    for ln in (40, 255, 256, 257, 600, 700):
        a = rng.integers(0, 4, ln).astype(np.uint8)
        a[: 2] = 0
        b = a.copy()
        b[rng.integers(0, ln, ln // 30 + 1)] = 1
        b[ln // 3], b[ln // 3 + 1] = b[ln // 3 + 1], b[ln // 3]
        b = np.insert(b, rng.integers(0, ln + 1, 9), 3).astype(np.uint8)
        a_list.append(a)
        b_list.append(b)
    # the cell (j, j) of a swap of b[j - 2] and b[j - 1] is a transposition
    bcols = _boundary_columns(threads, cols)
    for shift in (0, 1):
        a = rng.integers(0, 4, threads * cols + 37).astype(np.uint8)
        b = a.copy()
        for col in bcols[shift::2]:
            p = col + shift - 2
            if p + 1 < len(b) and b[p] != b[p + 1]:
                b[p], b[p + 1] = b[p + 1], b[p]
        a_list.append(a)
        b_list.append(b)
    a_list = [np.frombuffer(x, np.uint8) if isinstance(x, bytes) else x
              for x in a_list]
    b_list = [np.frombuffer(x, np.uint8) if isinstance(x, bytes) else x
              for x in b_list]
    t = sf.prepare_flat_distance_inputs(a_list, b_list, device="cpu")
    exp = scalar_banded_batch_native(a_list, b_list, 1 << 30, costs)
    for uk in (None, 12, 40):
        plain = sf.flat_distance_plain(*t, costs_t=ct, unit_k=uk,
                                       rj=threads * cols).numpy()
        out = _flat_distance_rehearsal(lib, t, ct, uk, threads, cols)
        assert np.array_equal(out, plain), uk
        thr = (uk or 1 << 20) * ct[1] + ct[2]
        within = exp <= thr
        assert np.array_equal(out[within], exp[within]), uk


@pytest.mark.parametrize("threads,cols", DIST_SHAPES, ids=DIST_SHAPE_IDS)
def test_flat_distance_body_keeps_the_band_entry_path(lib, threads, cols):
    """The band-entry repro (a = X^500, b = Y^32 + X^500, unit_k = 32,
    where the JAX package's banded kernel gives 33) at several launch
    shapes, so strip and warp boundaries fall on the path along the band's
    edge; and bursts of
    exactly unit_k inserted chars at the front and in the middle, against
    the compiled scalar distance."""
    x = np.full(500, ord("X"), np.uint8)
    rng = np.random.default_rng(999)
    r = rng.integers(0, 4, 500).astype(np.uint8)
    burst = rng.integers(0, 4, 32).astype(np.uint8)
    a_list = [x, r, r]
    b_list = [np.concatenate([np.full(32, ord("Y"), np.uint8), x]),
              np.concatenate([burst, r]), np.insert(r, 250, burst)]
    t = sf.prepare_flat_distance_inputs(a_list, b_list, device="cpu")
    for c in range(4):
        costs = EditCosts(*GENERAL_COSTS[c])
        ct = _gct(GENERAL_COSTS[c])
        out = _flat_distance_rehearsal(lib, t, ct, 32, threads, cols)
        exp = scalar_banded_batch_native(a_list, b_list, 1 << 30, costs)
        assert out.tolist() == exp.tolist(), c
        if c == 0:
            assert out[0] == 32

