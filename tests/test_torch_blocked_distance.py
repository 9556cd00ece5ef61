"""Kernel K5 of the PyTorch/CUDA port (ops/myers_chunked.py, distance mode)
and the distance route past the band plan, on the CPU.

The port's plain PyTorch version (what the CUDA kernel is held against on
the card) against the JAX package's chunked distance kernel in interpret
mode, on single-strip shapes only (a multi-strip interpret call costs 20-25
s here), and against the compiled CPU comparators of native/ across the
word and strip boundaries of the port's own plan.  Then the public
entry points on pairs past the band plan (unit_k > 4096): the dispatch
log reads `myers_blocked_distance` and the distances equal the JAX
package's public functions (its scan route) and the native comparators.
Integer results, exact equality.
"""

import importlib

import numpy as np
import pytest
import torch

from triple_accel_tpu.ops.pallas.myers_chunked import (
    blocked_distance_chunked,
    prepare_blocked_distance_inputs as jax_prepare_pairs,
)
from triple_accel_tpu.types import (
    LEVENSHTEIN_COSTS as J_LEV,
    RDAMERAU_COSTS as J_RDAM,
)

from triple_accel_tpu_torch.dispatch import dispatch_history
from triple_accel_tpu_torch.ops import myers_chunked as mc
from triple_accel_tpu_torch.types import LEVENSHTEIN_COSTS, RDAMERAU_COSTS
from triple_accel_tpu_torch.utils.native import (
    myers_distance_batch_native,
    scalar_banded_batch_native,
)

# one intra-op thread: the test workers run side by side on the
# machine's cores
torch.set_num_threads(1)

jl = importlib.import_module("triple_accel_tpu.levenshtein")
tl = importlib.import_module("triple_accel_tpu_torch.levenshtein")

CPU = dict(device="cpu")
U32_MAX = (1 << 32) - 1


def _native(a_list, b_list, k, damerau):
    if damerau:
        return scalar_banded_batch_native(a_list, b_list, k, RDAMERAU_COSTS)
    return myers_distance_batch_native(a_list, b_list, k)


def _edited(rng, a, n_edits, alphabet=4, swaps=0):
    """A copy of `a` with substitutions, insertions and deletions in equal
    parts, then `swaps` adjacent swaps."""
    b = list(a)
    for e in range(n_edits):
        op = e % 3
        if op == 0 and b:
            b[rng.integers(0, len(b))] = rng.integers(0, alphabet)
        elif op == 1:
            b.insert(int(rng.integers(0, len(b) + 1)),
                     int(rng.integers(0, alphabet)))
        elif b:
            del b[rng.integers(0, len(b))]
    b = np.array(b, dtype=np.uint8)
    for q in rng.integers(0, max(len(b) - 1, 1), swaps if len(b) > 1 else 0):
        b[q], b[q + 1] = b[q + 1], b[q]
    return b


def test_plan_alphabet_and_prep():
    def wpt_strips(m, rows):
        pl = mc.blocked_plan(m, rows)
        assert pl["lanes"] == 32 and pl["warps"] == 1  # a pair: a warp
        return pl["words_per_lane"], pl["strips"]

    assert mc.blocked_plan(0) is None
    # the main path's 20,000-char pairs: one strip of 20 words a lane
    assert wpt_strips(20_000, 5) == (20, 1)
    assert wpt_strips(64, 5) == (1, 1)
    assert wpt_strips(2049, 5) == (3, 1)
    assert wpt_strips(50_000, 5) == (20, 3)
    # a full-byte needle: the table of 257 rows allows 6 words a lane
    assert wpt_strips(20_000, 257) == (6, 4)
    assert wpt_strips(3000, 257) == (3, 1)
    rows = np.zeros((3, 40), np.uint8)
    rows[0, :5] = [7, 0, 7, 255, 3]
    rows[1, :3] = [9, 9, 9]
    rows[1, 3:] = 200  # pads past the length are not in the alphabet
    rows[2] = np.arange(40)
    codes, n_rows = mc.alphabet_codes(
        torch.from_numpy(rows), torch.tensor([5, 3, 40]))
    assert n_rows == 41
    assert codes.dtype == torch.int16 and codes.shape == (3, 256)
    c0 = codes[0].tolist()
    assert (c0[0], c0[3], c0[7], c0[255]) == (1, 2, 3, 4)
    assert sum(v > 0 for v in c0) == 4
    assert codes[1].tolist().count(1) == 1 and codes[1, 200] == 0
    assert codes[2, :40].tolist() == list(range(1, 41))
    a, b, m, n = mc.prepare_blocked_distance_inputs(
        [np.array([1, 2], np.uint8), np.empty(0, np.uint8)],
        [np.arange(17, dtype=np.uint8), np.array([5], np.uint8)], **CPU)
    assert a.shape == (2, 16) and b.shape == (2, 32)
    assert m.tolist() == [2, 0] and n.tolist() == [17, 1]
    assert b[0, :17].tolist() == list(range(17)) and int(b[0, 17:].sum()) == 0


@pytest.mark.parametrize("damerau", [False, True], ids=["unit", "rdamerau"])
def test_plain_equals_jax_interpret_single_strip(damerau):
    """Mixed shapes in one batch (an empty a, a one-char pair, very
    different lengths, NUL bytes, adjacent swaps): every lane of the JAX
    kernel's batch, padded lanes included, reaches the port through the
    bridge and gives the same number."""
    rng = np.random.default_rng(11 + damerau)
    pairs = [(30, 45), (5, 5), (0, 9), (12, 12), (19, 100), (1, 1), (64, 70),
             (65, 66)]
    a_list, b_list = [], []
    for ma, nb in pairs:
        a = rng.integers(0, 4, ma).astype(np.uint8)
        b = _edited(rng, a, 3, swaps=2)[:nb]
        b = np.concatenate([b, rng.integers(0, 4, nb - len(b))]
                           ).astype(np.uint8)
        a_list.append(a)
        b_list.append(b)
    nchar, seg, m_row, n_row, n_strips, n_chunks = jax_prepare_pairs(
        a_list, b_list)
    assert n_strips == 1 and n_chunks == 1
    ref = np.asarray(blocked_distance_chunked(
        nchar, seg, m_row, n_row, n_strips=n_strips, n_chunks=n_chunks,
        damerau=damerau, interpret=True))
    t = mc.from_reference_distance_inputs(nchar, seg, m_row, n_row, **CPU)
    got = mc.blocked_distance(*t, damerau=damerau).numpy()
    assert np.array_equal(got, ref)
    exp = _native(a_list, b_list, U32_MAX, damerau)
    assert np.array_equal(np.where(m_row[0, :len(a_list)] == 0,
                                   n_row[0, :len(a_list)],
                                   got[:len(a_list)]), exp)
    assert mc.blocked_distance.launches == 0  # CPU tensors never launch


@pytest.mark.parametrize("damerau", [False, True], ids=["unit", "rdamerau"])
def test_k_batch_past_band_plan_equals_jax_and_native(damerau):
    """levenshtein_k_batch past the band plan: lengths across the port's
    word (64), lane and strip boundaries and past 4096, a pair with a
    full-byte needle and NUL bytes, swapped pairs (len(a) > len(b)), an
    empty a, a short a against a long b; with rDamerau adjacent swaps and
    a finite threshold that one dissimilar pair passes (-1).  All pairs
    against the native comparator; the cheap ones against the JAX
    package's scan route too."""
    rng = np.random.default_rng(5 + damerau)
    a_list, b_list = [], []
    lengths = ((65, 4), (1300, 256), (2100, 4))
    if not damerau:
        lengths += ((4200, 4),)  # the one long pair (each column costs more)
    for ln, alphabet in lengths:
        a = rng.integers(0, alphabet, ln).astype(np.uint8)
        a[rng.integers(0, ln, 3)] = 0  # NUL bytes: pads are 0 too
        a_list.append(a)
        b_list.append(_edited(rng, a, ln // 10, alphabet,
                              swaps=ln // 50 if damerau else 0))
    a_list[0], b_list[0] = b_list[0], a_list[0]  # swapped: len(a) > len(b)
    cheap = [len(a_list)]
    a_list += [np.empty(0, np.uint8), rng.integers(0, 4, 40).astype(np.uint8)]
    b_list += [rng.integers(0, 4, 3000).astype(np.uint8),
               rng.integers(0, 4, 4150).astype(np.uint8)]
    cheap.append(cheap[0] + 1)
    k = U32_MAX
    if damerau:  # a pair at distance 4140 over a threshold past the plan
        a_list.append(np.full(40, 7, np.uint8))
        b_list.append(np.full(4140, 8, np.uint8))
        k = 4120
    costs, jcosts = ((RDAMERAU_COSTS, J_RDAM) if damerau
                     else (LEVENSHTEIN_COSTS, J_LEV))
    dispatch_history(clear=True)
    got = tl.levenshtein_k_batch(a_list, b_list, k, costs, **CPU)
    assert [d.path for _, d in dispatch_history()] == [
        "myers_blocked_distance"]
    assert np.array_equal(got, _native(a_list, b_list, k, damerau))
    if damerau:
        assert got[-1] == -1 and (got[:-1] >= 0).all()
    else:
        assert (got >= 0).all()
    ref = jl.levenshtein_k_batch([a_list[p] for p in cheap],
                                 [b_list[p] for p in cheap], k, jcosts)
    assert got[cheap].tolist() == np.asarray(ref).tolist()


def test_single_pair_wrappers_past_band_plan_equal_jax():
    """levenshtein, rdamerau and levenshtein_exp_batch past the band plan,
    on a short a against a long b (the JAX scan route stays cheap there),
    with an adjacent swap for rDamerau to find."""
    rng = np.random.default_rng(9)
    a = rng.integers(0, 4, 60).astype(np.uint8)
    b = np.concatenate([rng.integers(0, 4, 4100).astype(np.uint8), a])
    b[-30], b[-29] = b[-29], b[-30]
    near_a = rng.integers(0, 4, 200).astype(np.uint8)
    near_b = _edited(rng, near_a, 6)
    for fn in ("levenshtein", "rdamerau"):
        dispatch_history(clear=True)
        got = getattr(tl, fn)(a, b, **CPU)
        assert dispatch_history()[-1][1].path == "myers_blocked_distance"
        assert got == getattr(jl, fn)(a, b)
        assert got == _native([a], [b], U32_MAX, fn == "rdamerau")[0]
    dispatch_history(clear=True)
    got = tl.levenshtein_exp_batch([a, near_a], [b, near_b], **CPU)
    assert "myers_blocked_distance" in {d.path for _, d in dispatch_history()}
    assert got.tolist() == np.asarray(
        jl.levenshtein_exp_batch([a, near_a], [b, near_b])).tolist()
    assert got.tolist() == _native([a, near_a], [b, near_b], U32_MAX,
                                   False).tolist()


def test_force_path_band_keeps_the_jax_ladder(monkeypatch):
    """FORCE_PATH=band sends unit costs past the plan where the JAX package
    sends them: its flat distance, not the blocked kernel; the result is
    the oracle's (4200 substitutions and 100 insertions)."""
    monkeypatch.setenv("TRIPLE_ACCEL_TORCH_FORCE_PATH", "band")
    dispatch_history(clear=True)
    assert tl.levenshtein(np.zeros(4200, np.uint8), np.ones(4300, np.uint8),
                          **CPU) == 4300
    assert dispatch_history()[-1][1].path == "flat_distance"

