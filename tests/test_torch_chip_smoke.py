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

import chip_smoke as cs
from triple_accel_tpu_torch.oracle import levenshtein_naive_k_with_opts
from triple_accel_tpu_torch.types import (
    Edit,
    EditCosts,
    EditType,
    LEVENSHTEIN_COSTS,
    RDAMERAU_COSTS,
)

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
    assert cs.band_valid_cells(m, n, unit_k) == brute


def test_band_bound_counts_bytes_and_operations():
    m = np.array([10, 0]); n = np.array([12, 3])
    ct = (1, 1, 0, 1, True)
    plain = cs.band_bound(m, n, 4, ct, traced=False)
    traced = cs.band_bound(m, n, 4, ct, traced=True)
    cells = cs.band_valid_cells(m, n, 4)
    assert plain["cells"] == traced["cells"] == cells
    assert plain["ops_per_cell"] == (cs.BAND_OPS_PER_CELL
                                     + cs.BAND_OPS_TRANSPOSE)
    assert traced["ops_per_cell"] == plain["ops_per_cell"] + cs.BAND_OPS_CODE[
        True]
    # strings, two lengths and one distance a pair; traced: one packed code
    # word (band 9 < 16 cells) for each of the 10 rows
    assert plain["bound_bytes_ms"] == pytest.approx(
        (25 + 24) / cs.PEAK_BYTES_PER_S * 1e3)
    assert traced["bound_bytes_ms"] == pytest.approx(
        (25 + 24 + 40) / cs.PEAK_BYTES_PER_S * 1e3)
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
