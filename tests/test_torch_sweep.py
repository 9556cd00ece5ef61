"""Resumable sweeps of the PyTorch/CUDA port (`sweep.py`,
`utils/checkpoint.py`), on the CPU.

The port's `levenshtein_search_sweep` runs with device="cpu" (the
kernels' plain PyTorch versions) over an 8,000-byte haystack in
2,000-byte slabs and must equal, exactly, the JAX package's sweep, the
scalar oracle and the port's monolithic search, in Best and All mode.
Also: a resume from a seeded checkpoint, Best's running threshold shrinking
across slabs (the case of test_aux.py), the checkpoint's round trip and
its atomic write, checkpoints written by either package resumed by the
other, and `mesh=` (every slab sharded, equal to the meshless sweep).
"""

import importlib
import os

import numpy as np
import pytest
import torch

from triple_accel_tpu.oracle import levenshtein_search_naive_with_opts
from triple_accel_tpu.sweep import levenshtein_search_sweep as jax_sweep
from triple_accel_tpu.types import (
    EditCosts as JEditCosts,
    Match as JMatch,
    SearchType as JSearchType,
)
from triple_accel_tpu.utils.checkpoint import SweepCheckpoint as JCheckpoint

from triple_accel_tpu_torch.sweep import levenshtein_search_sweep
from triple_accel_tpu_torch.types import (
    LEVENSHTEIN_COSTS,
    Match,
    RDAMERAU_COSTS,
    SearchType,
)
from triple_accel_tpu_torch.utils.checkpoint import SweepCheckpoint

# one intra-op thread: the test workers run side by side on the
# machine's cores
torch.set_num_threads(1)

tl = importlib.import_module("triple_accel_tpu_torch.levenshtein")

CPU = dict(device="cpu")
N, SLAB = 8000, 2000
J_COSTS = {"unit": JEditCosts(1, 1, 0, None),
           "rdamerau": JEditCosts(1, 1, 0, 1)}
COSTS = {"unit": LEVENSHTEIN_COSTS, "rdamerau": RDAMERAU_COSTS}


def _as_tuples(matches):
    return [(m.start, m.end, m.k) for m in matches]


def _workload(seed: int = 3, n: int = N, m: int = 12):
    """Printable noise with 20 copies of the needle, some across slab
    edges, and one at the very start."""
    rng = np.random.default_rng(seed)
    needle = rng.integers(33, 127, m).astype(np.uint8)
    hay = rng.integers(33, 127, n).astype(np.uint8)
    places = [p for p in (0, SLAB - 5, 2 * SLAB - m + 1, 3 * SLAB - 1)
              if p + m <= n]
    for pos in places + rng.integers(0, n - m, 16).tolist():
        hay[pos: pos + m] = needle
        hay[pos + 3] = 33  # one substitution
    return needle, hay


@pytest.mark.parametrize("cname", ["unit", "rdamerau"])
@pytest.mark.parametrize("mode", ["All", "Best"])
def test_sweep_matches_jax_the_oracle_and_the_monolithic_search(cname,
                                                                mode):
    needle, hay = _workload()
    st, jst = SearchType[mode], JSearchType[mode]
    got = levenshtein_search_sweep(needle, hay, 2, st, COSTS[cname],
                                   slab_chars=SLAB, **CPU)
    ref = jax_sweep(needle, hay, 2, jst, J_COSTS[cname], slab_chars=SLAB)
    assert _as_tuples(got) == _as_tuples(ref)
    assert _as_tuples(got) == _as_tuples(levenshtein_search_naive_with_opts(
        needle, hay, 2, jst, J_COSTS[cname], False))
    assert got == tl.levenshtein_search_simd_with_opts(
        needle, hay, 2, st, COSTS[cname], False, **CPU)
    assert len(got) >= (20 if mode == "All" else 1)


def test_sweep_resumes_from_a_seeded_checkpoint(tmp_path):
    needle, hay = _workload()
    ck = str(tmp_path / "sweep.npz")
    full = levenshtein_search_sweep(needle, hay, 2, SearchType.All,
                                    slab_chars=SLAB, **CPU)
    # as if a preempted run had finished its first two slabs
    partial = SweepCheckpoint.load_or_create(ck)
    partial.advance(2 * SLAB, [mt for mt in full if mt.end <= 2 * SLAB])
    resumed = levenshtein_search_sweep(needle, hay, 2, SearchType.All,
                                       slab_chars=SLAB, checkpoint_path=ck,
                                       **CPU)
    assert resumed == full
    assert not os.path.exists(ck)  # consumed on success


def test_sweep_best_running_threshold_shrinks(tmp_path):
    """Best mode: the running minimum persists in the checkpoint and later
    slabs search with the shrunken threshold (test_aux.py's case)."""
    rng = np.random.default_rng(5)
    hay = rng.integers(65, 70, 4000).astype(np.uint8)
    needle = np.frombuffer(b"needle!x", np.uint8)
    hay[3500:3508] = needle  # exact hit late: curr_k must already be small
    hay[100:108] = needle
    hay[102] = 65  # one-off early hit
    ref = tl.levenshtein_search_simd_with_opts(needle, hay, 4,
                                               SearchType.Best, **CPU)
    ck = str(tmp_path / "s.npz")
    got = levenshtein_search_sweep(needle, hay, 4, SearchType.Best,
                                   slab_chars=512, checkpoint_path=ck, **CPU)
    assert got == ref == [Match(3500, 3508, 0)]
    assert _as_tuples(got) == _as_tuples(jax_sweep(
        needle, hay, 4, JSearchType.Best, slab_chars=512))
    # a run resumed after the first slab with curr_k = 1 saved keeps it:
    # the early one-off hit stays a candidate, the late exact one wins
    seeded = SweepCheckpoint(path=ck)
    seeded.advance(512, [Match(100, 108, 1)], curr_k=1)
    assert levenshtein_search_sweep(needle, hay, 4, SearchType.Best,
                                    slab_chars=512, checkpoint_path=ck,
                                    **CPU) == ref


def test_checkpoint_round_trip_and_atomic_write(tmp_path):
    p = str(tmp_path / "c.npz")
    c = SweepCheckpoint.load_or_create(p)
    assert (c.offset, c.matches, c.curr_k) == (0, [], None)
    c.advance(123, [Match(1, 5, 2)], curr_k=2)
    c.advance(456, [Match(300, 310, 1), Match(400, 409, 2)])
    c2 = SweepCheckpoint.load_or_create(p)
    assert c2.offset == 456
    assert c2.matches == [Match(1, 5, 2), Match(300, 310, 1),
                          Match(400, 409, 2)]
    assert c2.curr_k == 2
    assert os.listdir(tmp_path) == ["c.npz"]  # no temporary file left
    SweepCheckpoint(path=p, offset=7).save()
    c3 = SweepCheckpoint.load_or_create(p)
    assert (c3.offset, c3.matches, c3.curr_k) == (7, [], None)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_checkpoints_resume_across_the_packages(tmp_path, writer):
    """The same .npz keys: a checkpoint of either package resumes in the
    other, and both sweeps resume it to the same result."""
    needle, hay = _workload(9)
    full = levenshtein_search_sweep(needle, hay, 2, SearchType.All,
                                    slab_chars=SLAB, **CPU)
    first = [mt for mt in full if mt.end <= SLAB]
    ck = str(tmp_path / "x.npz")
    if writer == "jax":
        JCheckpoint.load_or_create(ck).advance(
            SLAB, [JMatch(mt.start, mt.end, mt.k) for mt in first], curr_k=2)
        back = SweepCheckpoint.load_or_create(ck)
    else:
        SweepCheckpoint.load_or_create(ck).advance(SLAB, first, curr_k=2)
        back = JCheckpoint.load_or_create(ck)
    assert (back.offset, back.curr_k) == (SLAB, 2)
    assert _as_tuples(back.matches) == _as_tuples(first)
    resumed = (levenshtein_search_sweep(needle, hay, 2, SearchType.All,
                                        slab_chars=SLAB, checkpoint_path=ck,
                                        **CPU)
               if writer == "jax" else
               jax_sweep(needle, hay, 2, JSearchType.All, slab_chars=SLAB,
                         checkpoint_path=ck))
    assert _as_tuples(resumed) == _as_tuples(full)
    assert not os.path.exists(ck)


def test_sweep_short_inputs_and_the_default_threshold():
    needle, hay = _workload(4, n=1500)
    # a haystack within one slab is one search; k None is ceil(m / 2)
    assert levenshtein_search_sweep(needle, hay, **CPU) == \
        tl.levenshtein_search_simd_with_opts(needle, hay, 6, **CPU)
    assert levenshtein_search_sweep(b"", hay, 3, SearchType.All,
                                    slab_chars=100, **CPU) == []


def test_sweep_mesh_raises():
    """`mesh=` runs every slab sharded across the mesh (it raised until
    the mesh layer was ported): equal to the meshless sweep."""
    from triple_accel_tpu_torch.parallel import make_mesh

    needle, hay = _workload(4, n=1500)
    for st in (SearchType.Best, SearchType.All):
        got = levenshtein_search_sweep(needle, hay, 6, st, slab_chars=300,
                                       mesh=make_mesh(["cpu"] * 3), **CPU)
        assert got == levenshtein_search_sweep(needle, hay, 6, st, **CPU)
