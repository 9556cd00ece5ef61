"""The host-side helpers of `chip_smoke.py`, on the CPU.

The smoke run itself needs a CUDA device; what decides its verdicts does
not: the generators of its check inputs (every pair must satisfy the band
kernels' contract), the replay that holds a traceback against its
distance, and the cell count behind the kernels' bounds.  They are held
here against the oracle and brute force, so that a wrong helper cannot
pass or fail a kernel on the card.
"""

import ast
import os

import numpy as np
import pytest
import torch

import chip_smoke as cs
from triple_accel_tpu_torch.oracle import levenshtein_naive_k_with_opts
from triple_accel_tpu_torch.types import (
    Edit,
    EditCosts,
    EditType,
    LEVENSHTEIN_COSTS,
    RDAMERAU_COSTS,
)
from triple_accel_tpu_torch.utils import profiling as prof

# one intra-op thread: the test workers run side by side on the
# machine's cores
torch.set_num_threads(1)

COSTS = [LEVENSHTEIN_COSTS, RDAMERAU_COSTS, EditCosts(*cs.AFFINE),
         EditCosts(3, 2, 1, 2)]


@pytest.mark.parametrize("unit_k,max_m", [(4, 24), (32, 90), (100, 40)])
def test_band_cases_satisfy_the_kernel_contract(unit_k, max_m):
    rng = np.random.default_rng(unit_k)
    a_list, b_list = cs.band_cases(rng, 64, max_m, unit_k)
    la = np.array([len(a) for a in a_list])
    lb = np.array([len(b) for b in b_list])
    assert ((la <= lb) & (lb - la <= unit_k) & (la <= max_m)).all()
    assert la[0] == lb[0] == 0 and la[1] == 0
    assert (lb - la == unit_k).sum() >= 64 // 3  # pairs at the band's edge
    assert (la == max_m).any()
    assert any((a == 0).any() for a in a_list)  # NUL bytes
    assert all(x.dtype == np.uint8 for x in a_list + b_list)
    # the pairs with swaps on the diagonals of the warp regime's lane edges
    for cells in (3, 5, 9, 17):
        a_e, b_e = cs.lane_edge_pairs(rng, unit_k, cells, max_m)
        la = np.array([len(a) for a in a_e])
        lb = np.array([len(b) for b in b_e])
        assert ((la <= lb) & (lb - la <= unit_k) & (la <= max_m)).all()
        edges = {d + unit_k for d in (lb - la).tolist()}
        assert all(e % cells in (0, cells - 1) for e in edges)
        assert len(a_e) == min(8, len(edges)) and (cells > 2 * unit_k
                                                   or a_e)


def test_edited_pairs_keep_their_length_rules():
    a_list, b_list = cs.make_edited_pairs(40, 300, 10, 6, seed=3)
    for a, b in zip(a_list, b_list):
        assert len(a) == 300 and 300 <= len(b) <= 306
        assert a.dtype == b.dtype == np.uint8
    rows = np.stack(a_list)
    before = rows.copy()
    cs.swap_adjacent(rows, 3, np.random.default_rng(1))
    assert (np.sort(rows, axis=1) == np.sort(before, axis=1)).all()
    assert ((rows != before).sum(axis=1) <= 6).all() and (rows != before).any()


@pytest.mark.parametrize("costs", COSTS,
                         ids=["unit", "rdamerau", "affine", "affine_transpose"])
def test_replay_cost_equals_the_oracle_distance(costs):
    rng = np.random.default_rng(costs.mismatch_cost + costs.gap_cost)
    a_list, b_list = cs.band_cases(rng, 48, 30, 8)
    for a, b in zip(a_list, b_list):
        for x, y in ((a, b), (b, a)):  # the longer string first, too
            dist, edits = levenshtein_naive_k_with_opts(x, y, 10**6, True,
                                                        costs)
            cost = cs.replay_cost(x, y, edits, costs)
            if costs.start_gap_cost == 0:
                assert cost == dist
            else:
                # one code per cell cannot say whether the cell a gap came
                # from was itself inside a gap, so with a start cost the
                # reference's traceback may open a gap the optimum extends
                assert cost >= dist


def test_replay_cost_refuses_wrong_tracebacks():
    a = np.frombuffer(b"abcd", np.uint8)
    b = np.frombuffer(b"abdc", np.uint8)
    ok = [Edit(EditType.Match, 2), Edit(EditType.Transpose, 1)]
    assert cs.replay_cost(a, b, ok, RDAMERAU_COSTS) == 1
    for bad in (
        [Edit(EditType.Match, 4)],  # a match over differing characters
        [Edit(EditType.Match, 2), Edit(EditType.Mismatch, 1)],  # too short
        [Edit(EditType.Match, 2), Edit(EditType.Mismatch, 3)],  # too long
        [Edit(EditType.Mismatch, 2), Edit(EditType.Mismatch, 2)],  # equal
        [Edit(EditType.Match, 1), Edit(EditType.Transpose, 1),
         Edit(EditType.Match, 1)],  # not a swap
        [Edit(EditType.Match, 2), Edit(EditType.AGap, 2)],  # a not consumed
    ):
        assert cs.replay_cost(a, b, bad, RDAMERAU_COSTS) == -1


@pytest.mark.parametrize("unit_k", [0, 3, 40])
def test_band_valid_cells_equals_brute_force(unit_k):
    rng = np.random.default_rng(unit_k)
    m = rng.integers(0, 30, 20)
    n = m + rng.integers(0, unit_k + 1, 20)
    brute = sum(
        1 for mm, nn in zip(m.tolist(), n.tolist())
        for i in range(1, mm + 1) for c in range(2 * unit_k + 1)
        if 0 <= i + c - unit_k <= nn)
    assert prof.band_valid_cells(m, n, unit_k) == brute


def test_band_bound_counts_bytes_and_operations():
    m = np.array([10, 0]); n = np.array([12, 3])
    ct = (1, 1, 0, 1, True)
    plain = prof.band_bound(m, n, 4, ct, traced=False)
    traced = prof.band_bound(m, n, 4, ct, traced=True)
    cells = prof.band_valid_cells(m, n, 4)
    assert plain["cells"] == traced["cells"] == cells
    assert plain["ops_per_cell"] == (prof.BAND_OPS_PER_CELL
                                     + prof.BAND_OPS_TRANSPOSE)
    assert traced["ops_per_cell"] == plain["ops_per_cell"] + prof.BAND_OPS_CODE[
        True]
    # strings, two lengths and one distance a pair; traced: one packed code
    # word (band 9 < 16 cells) for each of the 10 rows
    assert plain["bound_bytes_ms"] == pytest.approx(
        (25 + 24) / prof.PEAK_BYTES_PER_S * 1e3)
    assert traced["bound_bytes_ms"] == pytest.approx(
        (25 + 24 + 40) / prof.PEAK_BYTES_PER_S * 1e3)
    assert plain["bound_ms"] == max(plain["bound_bytes_ms"],
                                    plain["bound_operations_ms"])


def test_planted_alone_drops_overlapping_copies():
    planted = np.arange(0, 64 * 100, 100)
    planted[5] = planted[4] + 3  # overlaps its neighbour
    alone = cs.planted_alone(np.sort(planted))
    assert planted[4] not in alone and planted[5] not in alone
    assert alone.size == 62


def test_smoke_run_fails_without_a_card_and_imports_no_jax(capsys,
                                                           monkeypatch):
    monkeypatch.setattr(cs.torch.cuda, "is_available", lambda: False)
    assert cs.main() == 2  # no CUDA device: non-zero, no result line
    assert capsys.readouterr().out == ""
    with open(os.path.abspath(cs.__file__)) as fh:
        tree = ast.parse(fh.read())
    imported = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            imported.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            imported.add((node.module or "").split(".")[0])
    assert "jax" not in imported and "triple_accel_tpu" not in imported


def test_long_pairs_and_swaps_keep_their_rules():
    from triple_accel_tpu_torch.utils.native import (
        myers_distance_batch_native, scalar_banded_batch_native)

    a_list, b_list = cs.make_long_pairs(8, 300, 0.1, seed=4)
    acgt = set(cs.ACGT.tolist())
    for a, b in zip(a_list, b_list):
        assert len(a) == 300 and 270 <= len(b) <= 330
        assert set(a.tolist()) <= acgt and set(b.tolist()) <= acgt
    d = myers_distance_batch_native(a_list, b_list, 10**6)
    assert (d >= 1).all() and (d <= 30).all()
    swapped = cs.swap_adjacent_list(b_list, 0.02, np.random.default_rng(5))
    for b, s in zip(b_list, swapped):
        assert len(s) == len(b) and sorted(s.tolist()) == sorted(b.tolist())
    unit = myers_distance_batch_native(a_list, swapped, 10**6)
    rdam = scalar_banded_batch_native(a_list, swapped, 10**6, RDAMERAU_COSTS)
    assert (rdam <= unit).all() and (rdam < unit).any()


def test_long_haystack_copies_are_found_where_they_were_planted(
        monkeypatch):
    from triple_accel_tpu_torch.utils.native import (
        search_all_native, search_intervals_native)

    monkeypatch.setattr(cs, "COPY_FREE_BYTES", 20_000)
    m, subs = 200, 4
    needle, hay, planted = cs.make_long_haystack(28_000, m, 6, subs, seed=6)
    assert planted[0] == 0 and (np.diff(planted) >= m).all()
    assert planted[-1] + m <= len(hay) - cs.COPY_FREE_BYTES
    for pos in planted.tolist():
        assert (hay[pos: pos + m] != needle).sum() == subs
    full = search_all_native(needle, hay, 20, LEVENSHTEIN_COSTS)
    by_end = dict(zip(full[0].tolist(), full[1].tolist()))
    assert all(by_end[pos + m] <= subs for pos in planted.tolist())
    assert not (full[0] > len(hay) - cs.COPY_FREE_BYTES).any()
    # the reference's intervals hold every candidate of the whole haystack
    starts, stops = cs.long_search_intervals(planted, m, 20, len(hay))
    assert (starts[1:] > stops[:-1]).all()
    assert stops[-1] == len(hay) and starts[-1] <= len(hay) - 20_000
    got = search_intervals_native(needle, hay, starts, stops, 20,
                                  LEVENSHTEIN_COSTS)
    assert all(np.array_equal(x, y) for x, y in zip(got, full))


def test_k5_and_k6_bounds_count_bytes_and_operations():
    m = np.array([64, 65, 0])
    n = np.array([100, 10, 5])
    b = prof.k5_bound(m, n, False)
    ops = 100 * (2 * 11 + 3) + 10 * (3 * 11 + 3) + 5 * 3
    assert prof.K5_OPS_PER_COL_WORD32 == {False: 11, True: 15}
    assert b["bound_operations_ms"] == pytest.approx(
        ops / prof.PEAK_INT32_OPS_PER_S * 1e3)
    assert b["bound_bytes_ms"] == pytest.approx(
        (129 + 115 + 36) / prof.PEAK_BYTES_PER_S * 1e3)
    assert b["bound_ms"] == max(b["bound_bytes_ms"],
                                b["bound_operations_ms"])
    r = prof.k6_bound(1000, 3000, True)
    assert r["bound_operations_ms"] == pytest.approx(
        1000 * (94 * 15 + 4) / prof.PEAK_INT32_OPS_PER_S * 1e3)
    assert r["bound_by"] == "operations"
    # the full-size distance phase's reckoning: about 9 ms
    full = prof.k5_bound(np.full(1024, 20_000), np.full(1024, 20_000), False)
    assert 8 < full["bound_ms"] < 11


def test_blocked_distance_cases_cross_the_plan_boundaries():
    """Every batch of the K5 checks: each word count a lane the kernel is
    built for, strips at 20 and at 6 words a lane; both sides of a lane's
    words and of a strip; short texts; NUL bytes; one full-byte needle."""
    from triple_accel_tpu_torch.ops.myers_chunked import blocked_plan

    plans = set()
    for max_m, full_byte in cs.BLOCKED_CHECKS:
        rng = np.random.default_rng(max_m)
        a_list, b_list = cs.blocked_distance_cases(
            rng, cs.BLOCKED_CHECK_PAIRS, max_m, full_byte)
        la = [len(a) for a in a_list]
        assert len(a_list) == cs.BLOCKED_CHECK_PAIRS and la[0] == 0
        assert max(la) == max_m
        assert max(len(b) for b in b_list) <= cs.BLOCKED_CHECK_COLS + 30
        assert all((a == 0).any() for a in a_list[1:])  # NUL bytes
        distinct = max(len(set(a.tolist())) for a in a_list)
        assert (distinct == 256) == full_byte
        pl = blocked_plan(max_m, distinct + 1)
        wpt, strips = pl["words_per_lane"], pl["strips"]
        plans.add((wpt, strips > 1))
        assert {32 * wpt, 32 * wpt + 1} <= set(la)  # a lane's words
        if strips > 1:
            assert {1024 * wpt, 1024 * wpt + 1} <= set(la)  # a strip
    assert {w for w, _ in plans} == {1, 2, 3, 4, 6, 8, 12, 20}
    assert {(20, True), (6, True)} <= plans


def test_general_search_inputs_and_windows():
    """The K7 / K8 check inputs hold NUL bytes and copies with an adjacent
    swap; the copies' windows and the copy-free stretch cover what the
    search phases hold against the compiled scalar search."""
    rng = np.random.default_rng(3)
    hay, needle = cs.search_check_input(rng, 5000, 40, 4, 3)
    assert hay[:3].tolist() == [0, 0, 0] and 0 in needle
    assert len(hay) == 5000 and len(needle) == 40
    assert (hay[3:40] != needle[3:]).sum() <= 3 + 2  # the copy at 0
    planted = np.array([100, 5000, 5030, 90_000])
    free = cs.copy_free_start(planted, 24, 30, 200_000, 20_000)
    assert free == 5030 + 24 + 30  # the first gap wide enough
    starts, ends = cs.copy_windows(planted, 24, 30, 200_000, free, 20_000)
    assert starts.tolist() == [70, 4970, 89_970]  # touching ones merge
    assert ends.tolist() == [154, free + 20_000, 90_054]
    with pytest.raises(RuntimeError, match="copy-free"):
        cs.copy_free_start(planted, 24, 30, 100_000, 90_000)


def test_band_entry_pairs_run_along_the_band_edge():
    rng = np.random.default_rng(4)
    a_list, b_list = cs.band_entry_pairs(300, 16, rng)
    from triple_accel_tpu_torch.utils.native import (
        scalar_banded_batch_native)

    assert [len(b) - len(a) for a, b in zip(a_list, b_list)] == [16] * 3
    exact = scalar_banded_batch_native(a_list, b_list, 10**6,
                                       LEVENSHTEIN_COSTS)
    assert exact.tolist()[0] == 16 and (exact <= 16).all()
    banded = scalar_banded_batch_native(a_list, b_list, 16,
                                        LEVENSHTEIN_COSTS)
    assert banded.tolist() == exact.tolist()


def test_k7_k8_k9_bounds_count_bytes_and_operations():
    b = prof.search_lengths_bound(1000, 24, False, prof.K7_OPS_PER_CELL,
                                  prof.K7_OPS_TRANSPOSE)
    assert b["bound_operations_ms"] == pytest.approx(
        1000 * 24 * 24 / prof.PEAK_INT32_OPS_PER_S * 1e3)
    assert b["bound_bytes_ms"] == pytest.approx(
        (1000 + 8 * 1001 + 24) / prof.PEAK_BYTES_PER_S * 1e3)
    bt = prof.search_lengths_bound(1000, 24, True, prof.K8_OPS_PER_CELL,
                                   prof.K8_OPS_TRANSPOSE)
    assert bt["bound_operations_ms"] == pytest.approx(
        b["bound_operations_ms"] * 30 / 24)
    assert b["bound_by"] == "operations"
    # K9 counts K3's function over the band's cells: the whole matrix here
    m_arr, n_arr = np.array([300, 0]), np.array([310, 5])
    k9 = prof.band_bound(m_arr, n_arr, 1 << 15, (2, 1, 2, 0, False), False)
    assert k9["cells"] == 300 * 311
    assert prof.K9_OPS_PER_CELL == prof.BAND_OPS_PER_CELL


def test_dictionary_copies_lie_where_they_were_planted():
    """The dictionary phase's input: every copy in its own slot with its
    substitutions, the prefix needles once inside the first MiB, upper-case
    noise elsewhere; and its launch plan read from the entry point's."""
    n = 3 << 20
    hay, groups, where = cs.make_dictionary(n)
    assert [len(groups[g]) for g in ("short", "long", "general")] == [
        len(cs.DICT_LENS) * cs.DICT_PER_LEN, cs.DICT_LONG[0],
        cs.DICT_GENERAL[0]]
    assert len(where["short"]) == cs.DICT_PLANTED
    starts = []
    for g, subs in (("long", [cs.DICT_LONG[4]]),
                    ("general", [cs.DICT_GENERAL[4]]), ("short", [1, 2])):
        for i, poss in where[g].items():
            nd = groups[g][i]
            for pos in poss:
                assert int((hay[pos: pos + len(nd)] != nd).sum()) in subs
                starts.append(pos)
    assert len(set(p // cs.DICT_SLOT for p in starts)) == len(starts)
    prefix = sorted(where["short"])[: cs.DICT_PREFIX_NEEDLES]
    assert all(min(where["short"][i]) + 32 <= 1 << 20 for i in prefix)
    lower = hay >= 97
    assert int(lower.sum()) == sum(
        len(groups[g][i]) * len(p) for g in where for i, p in where[g].items())
    plan = cs.dictionary_plan(groups["short"] + groups["long"], n, 3,
                              LEVENSHTEIN_COSTS)
    assert sorted(plan) == [16, 20, 24, 32, 400]
    assert all(sum(v) == cs.DICT_PER_LEN for m, v in plan.items() if m < 400)
