"""The frozen cost model against the program's `utils/profiling` at the
cells' shapes: the same counts, but for the unbounded distance, which
counts the answer's band instead of the full matrix."""

import numpy as np

from portbench.metrics import cost_model
from portbench.traffic import edit_acgt, random_acgt
from triple_accel_tpu_torch.utils import profiling

AFFINE = {"mismatch_cost": 4, "gap_cost": 2, "start_gap_cost": 6,
          "transpose_cost": None}
UNIT = {"mismatch_cost": 1, "gap_cost": 1, "start_gap_cost": 0,
        "transpose_cost": None}
CT = (4, 2, 6, 0, False)
HAY = 46_709_983


def _pairs(n_pairs=6, length=10_000):
    rng = np.random.default_rng(3)
    a = random_acgt(rng, (n_pairs, length))
    b = [edit_acgt(x, int(length * 0.05), rng) for x in a]
    la = np.full(n_pairs, length)
    lb = np.array([len(x) for x in b])
    return np.minimum(la, lb), np.maximum(la, lb)


def test_peaks_equal_profiling():
    assert cost_model.PEAK_BYTES_PER_S == profiling.PEAK_BYTES_PER_S
    assert cost_model.PEAK_INT32_OPS_PER_S == profiling.PEAK_INT32_OPS_PER_S


def test_banded_cell_equals_profiling():
    m, n = _pairs()
    mine = cost_model.pairs_bound(m, n, 3090, AFFINE)
    theirs = profiling.band_bound(m, n, (3090 - 6) // 2, CT, False)
    assert mine["cells"] == theirs["cells"]
    assert mine["ops"] == theirs["cells"] * theirs["ops_per_cell"]
    assert np.isclose(mine["bound_s"], theirs["bound_ms"] * 1e-3)


def test_longread_cell_equals_profiling():
    mine = cost_model.search_bound(HAY, [3000, 3000], AFFINE, unit=False)
    theirs = profiling.k8_bound(HAY, 3000, False)
    assert np.isclose(mine["ops"] / cost_model.PEAK_INT32_OPS_PER_S,
                      2 * theirs["bound_operations_ms"] * 1e-3)
    assert mine["bound_by"] == theirs["bound_by"] == "operations"


def test_primers_cell_equals_profiling():
    lens = 18 + np.arange(512) % 10
    mine = cost_model.search_bound(HAY, lens, UNIT, unit=True)
    ops_s = sum(profiling.k2_bound(HAY, int(m), False)["bound_operations_ms"]
                for m in lens) * 1e-3
    assert np.isclose(mine["ops"] / cost_model.PEAK_INT32_OPS_PER_S, ops_s)
    # the function's bytes: the reference once a call, not once a needle
    # with a distance written a column as the K2 kernel's count has them
    assert mine["bound_by"] == "operations"


def test_exact_cell_differs_only_by_the_answers_band():
    m, n = _pairs()
    d = np.array([3300, 3250, 3400, 3320, 3280, 3310])
    mine = cost_model.pairs_bound(m, n, 2**32 - 1, AFFINE, dists=d)
    uk = (d - 6) // 2
    want = sum(profiling.band_valid_cells(m[i:i + 1], n[i:i + 1], int(uk[i]))
               for i in range(len(d)))
    assert mine["cells"] == want
    # the program's count at the unbounded threshold: the full matrix
    full = profiling.band_bound(m, n, int(n.max()), CT, False)["cells"]
    assert full == int((m * (n + 1)).sum()) > 2 * mine["cells"]
    assert cost_model.pairs_bound(m, n, 2**32 - 1, AFFINE)["cells"] == full
