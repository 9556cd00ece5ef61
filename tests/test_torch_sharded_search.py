"""Search over a haystack sharded across a mesh, on the CPU.

`levenshtein_search_sharded`, `levenshtein_search_many(mesh=)` with its
resident `PackedHaystack.pack_sharded`, `hamming_search_sharded` and the
sweep with `mesh=` run on CPU meshes (`make_mesh(["cpu"] * D)`: each shard
the kernels' plain PyTorch versions) and must equal, exactly, the
meshless call, the scalar oracle and, where the JAX package's mesh path
takes the input, its call on the virtual CPU devices.  A seeded fuzz over
24 adversarial shard geometries holds mesh == meshless == oracle: n not a
multiple of D, a halo equal to a shard and longer than one or two, a
match across three shards, empty shards (n < D), needles longer than a
shard or than the haystack, k at the span's edges, copies ending on a
shard's edge, hits everywhere.  Every plain-version tensor stays under
32,768 elements.
"""

import importlib

import jax
import numpy as np
import pytest
import torch

from triple_accel_tpu.oracle import levenshtein_search_naive_with_opts
from triple_accel_tpu.parallel import make_mesh as jax_mesh
from triple_accel_tpu.types import EditCosts as JEditCosts
from triple_accel_tpu.types import SearchType as JSearchType

from triple_accel_tpu_torch.dispatch import dispatch_history
from triple_accel_tpu_torch.parallel import make_mesh
from triple_accel_tpu_torch.sweep import levenshtein_search_sweep
from triple_accel_tpu_torch.types import EditCosts, SearchType
from triple_accel_tpu_torch.utils.checkpoint import SweepCheckpoint

# one intra-op thread: the test workers run side by side on the
# machine's cores
torch.set_num_threads(1)

jl = importlib.import_module("triple_accel_tpu.levenshtein")
jh = importlib.import_module("triple_accel_tpu.hamming")
tl = importlib.import_module("triple_accel_tpu_torch.levenshtein")
th = importlib.import_module("triple_accel_tpu_torch.hamming")

CPU = dict(device="cpu")
UNIT, RDAM, AFFINE, GENERAL = ((1, 1, 0, None), (1, 1, 0, 1),
                               (2, 1, 2, None), (3, 2, 1, 2))
MODES = (SearchType.Best, SearchType.All)


def _mesh(D):
    return make_mesh(["cpu"] * D)


def _tuples(matches):
    return [(m.start, m.end, m.k) for m in matches]


def _oracle(needle, hay, k, st, c):
    return _tuples(levenshtein_search_naive_with_opts(
        needle, hay, k, JSearchType[st.name], JEditCosts(*c), False))


def _input(seed, n, m, plants, alpha=4):
    """Noise over `alpha` letters with copies of the needle at `plants`
    (each with one substitution past the first copy)."""
    rng = np.random.default_rng(seed)
    needle = rng.integers(65, 65 + alpha, m).astype(np.uint8)
    hay = rng.integers(65, 65 + alpha, n).astype(np.uint8)
    for i, p in enumerate(plants):
        p = min(max(p, 0), max(n - m, 0))
        w = min(m, n - p)
        hay[p:p + w] = needle[:w]
        if i and w > 2:
            hay[p + w // 2] = 65 + (hay[p + w // 2] - 64) % alpha
    return needle, hay


def _check_all_ways(needle, hay, k, c, D):
    """mesh == meshless == oracle, Best and All."""
    for st in MODES:
        got = tl.levenshtein_search_sharded(needle, hay, k, _mesh(D), st,
                                            EditCosts(*c), **CPU)
        one = tl.levenshtein_search_simd_with_opts(needle, hay, k, st,
                                                   EditCosts(*c), **CPU)
        assert got == one, (st, D)
        assert _tuples(got) == _oracle(needle, hay, k, st, c), (st, D)


@pytest.mark.parametrize("c", [UNIT, RDAM, AFFINE],
                         ids=["unit", "rdamerau", "affine"])
def test_search_sharded_equals_jax_and_oracle(c):
    """A Best tie across shards and copies across every shard edge; the
    JAX package's mesh call runs on 4 virtual CPU devices."""
    n, m, k = 600, 10, (3 if c != AFFINE else 6)
    needle, hay = _input(21, n, m, [10, 150 - 4, 300 - 9, 450, 598])
    hay[10:20] = hay[450:460] = needle  # two exact copies: a Best tie
    _check_all_ways(needle, hay, k, c, 4)
    for st in MODES:
        ref = jl.levenshtein_search_sharded(
            needle, hay, k, jax_mesh(jax.devices()[:4]),
            JSearchType[st.name], JEditCosts(*c))
        got = tl.levenshtein_search_sharded(needle, hay, k, _mesh(4), st,
                                            EditCosts(*c), **CPU)
        assert _tuples(got) == _tuples(ref), st


# (name, D, n, m, k, costs, plants as fractions of the shard size S)
GEOMETRIES = [
    # n not a multiple of D
    ("uneven_301_over_3", 3, 301, 8, 2, UNIT, (0.9, 1.95, 2.97)),
    ("uneven_257_over_4", 4, 257, 12, 3, RDAM, (0.8, 2.9, 3.5)),
    ("uneven_100_over_7", 7, 100, 5, 1, UNIT, (0.5, 2.8, 6.1)),
    ("uneven_123_over_5", 5, 123, 9, 4, AFFINE, (0.7, 1.9, 4.0)),
    # the halo against the shard: equal, longer, longer than two
    ("halo_equals_shard", 4, 160, 30, 10, UNIT, (0.5, 1.5, 3.2)),
    ("halo_equals_shard_rdamerau", 3, 90, 25, 5, RDAM, (0.3, 1.2)),
    ("halo_longer_than_shard", 4, 100, 20, 12, UNIT, (0.2, 1.9, 3.0)),
    ("halo_longer_than_two", 6, 60, 15, 10, AFFINE, (0.5, 2.5, 4.4)),
    # a match across three shards and more
    ("match_over_three_shards", 4, 120, 50, 5, UNIT, (0.66, 2.5)),
    ("match_over_three_rdamerau", 5, 100, 45, 8, RDAM, (0.75,)),
    ("match_over_three_general", 3, 90, 70, 6, GENERAL, (0.33,)),
    ("match_over_four_shards", 8, 200, 60, 10, UNIT, (0.8, 5.0)),
    # empty shards (n < D), needles longer than a shard or the haystack
    ("empty_shards", 8, 5, 3, 1, UNIT, (0.0,)),
    ("empty_shards_rdamerau", 6, 3, 3, 0, RDAM, (0.0,)),
    ("needle_past_the_haystack", 4, 2, 4, 3, UNIT, ()),
    ("empty_shards_general", 5, 4, 2, 2, AFFINE, (1.0,)),
    ("needle_longer_than_a_shard", 4, 40, 16, 3, UNIT, (0.5, 2.2)),
    ("needle_longer_rdamerau", 3, 31, 20, 2, RDAM, (0.4,)),
    # k at the span's edges: span = m + k one under, at and over S = 20
    ("k_span_under_shard", 4, 80, 12, 7, UNIT, (0.6, 1.95, 2.4)),
    ("k_span_at_shard", 4, 80, 12, 8, UNIT, (0.6, 1.95, 2.4)),
    ("k_span_over_shard", 4, 80, 12, 9, UNIT, (0.6, 1.95, 2.4)),
    ("k_span_whole_haystack", 3, 60, 6, 60, UNIT, (1.0,)),
    # copies ending on a shard's last byte and starting on the next one
    ("copies_on_the_edge", 2, 64, 10, 3, UNIT, (0.6875, 1.0)),
    ("one_device", 1, 50, 7, 2, AFFINE, (0.3,)),
]


@pytest.mark.parametrize("group", range(6), ids=[
    "uneven", "halo_vs_shard", "three_shards", "empty_and_long",
    "needles_and_k", "k_and_edges"])
def test_shard_geometry_fuzz(group):
    """Four geometries a case, 24 in all, each with seeded noise: mesh ==
    meshless == oracle, Best and All."""
    for i, (name, D, n, m, k, c, plants) in enumerate(
            GEOMETRIES[4 * group: 4 * group + 4]):
        S = -(-n // D)
        needle, hay = _input(100 + 4 * group + i, n, m,
                             [int(f * S) for f in plants])
        try:
            _check_all_ways(needle, hay, k, c, D)
        except AssertionError as e:
            raise AssertionError(f"{name}: {e}") from None


def test_dense_hits_resolve_shard_by_shard(monkeypatch):
    """A hit stream past the replay budget gets its lengths from K8 a
    shard, over the shard's own window."""
    monkeypatch.setattr(tl, "_RESOLVE_CELLS_BUDGET", 10_000)
    needle, hay = b"ab" * 20, b"ab" * 600
    dispatch_history(clear=True)
    got = tl.levenshtein_search_sharded(needle, hay, 38, _mesh(3),
                                        SearchType.All, **CPU)
    assert [d.path for _, d in dispatch_history()] == [
        "myers_search_sharded"] + ["flat_resolve"] * 3
    assert got == tl.levenshtein_search_simd_with_opts(
        needle, hay, 38, SearchType.All, **CPU)


def test_search_many_mesh_more_than_eight_needles():
    """12 needles of 7 lengths (an empty one, one of 400 chars on K6) over
    one PackedHaystack on meshes of 3 and 5: equal to the meshless call
    and the oracle; general costs go a needle at a time."""
    rng = np.random.default_rng(31)
    hay = rng.integers(65, 69, 700).astype(np.uint8)
    lens = (5, 5, 9, 9, 9, 24, 0, 5, 3, 30, 9, 400)
    needles = [rng.integers(65, 69, L).astype(np.uint8) for L in lens]
    needles[2], needles[5] = hay[230:239].copy(), hay[228:252].copy()
    ph = tl.PackedHaystack(hay, **CPU)
    want = {}
    for D, c, st in ((3, UNIT, SearchType.All), (5, UNIT, SearchType.All),
                     (3, RDAM, SearchType.Best), (5, AFFINE, SearchType.All)):
        nds = needles if c != AFFINE else needles[4:7]
        if (c, st) not in want:
            want[c, st] = tl.levenshtein_search_many(nds, hay, 3, st,
                                                     EditCosts(*c), **CPU)
        dispatch_history(clear=True)
        got = tl.levenshtein_search_many(nds, ph, 3, st, EditCosts(*c),
                                         mesh=_mesh(D), **CPU)
        paths = {d.path for _, d in dispatch_history()}
        assert got == want[c, st], (D, c)
        if c == AFFINE:
            assert paths == {"search_diag_sharded"}
        else:
            assert paths == {"myers_search_many_sharded",
                             "myers_search_many_blocked_sharded"}
    for nd, ms in zip(needles, want[UNIT, SearchType.All]):
        assert _tuples(ms) == _oracle(nd, hay, 3, SearchType.All, UNIT)
    assert sum(map(len, want[UNIT, SearchType.All])) > 12


def test_pack_sharded_is_memoized():
    rng = np.random.default_rng(32)
    hay = rng.integers(65, 69, 500).astype(np.uint8)
    ph = tl.PackedHaystack(hay, **CPU)
    m3, m4 = _mesh(3), _mesh(4)
    wins = ph.pack_sharded(m3, 40)
    assert ph.uploads == 3
    assert ph.pack_sharded(make_mesh(["cpu"] * 3), 8) is wins  # same mesh
    assert ph.uploads == 3
    needles = [hay[100:110].copy(), hay[300:312].copy()]
    got = tl.levenshtein_search_many(needles, ph, 3, SearchType.All,
                                     mesh=m3, **CPU)
    assert ph.uploads == 3  # a halo of 15 is served by the pack of 40
    wins = ph.pack_sharded(m3, 64)  # a larger halo repacks
    assert ph.uploads == 6
    # the view of a smaller halo starts on a 32-byte boundary of the
    # window, at least the asked halo before the shard
    view, h = wins.view(1, 15)
    assert h == 32 and view.shape[0] == wins.windows[1].shape[0] - 32
    assert wins.view(0, 15)[1] == 0 and wins.view(2, 64)[1] == 64
    ph.pack_sharded(m4, 8)  # another mesh: a pack of its own
    assert ph.uploads == 10
    assert tl.levenshtein_search_many(needles, ph, 3, SearchType.All,
                                      mesh=m3, **CPU) == got
    assert ph.uploads == 10
    assert ph.device_haystack() is not None and ph.uploads == 11


def test_sweep_resumes_on_another_mesh_size(tmp_path):
    """A sweep on a mesh of 3 resumes on a mesh of 4 and on none: the
    checkpoint's keys do not depend on the mesh."""
    needle, hay = _input(33, 1200, 10, [150, 299, 300 - 5, 700, 1190])
    ck = str(tmp_path / "sweep.npz")
    full = tl.levenshtein_search_simd_with_opts(needle, hay, 3,
                                                SearchType.All, **CPU)
    assert levenshtein_search_sweep(needle, hay, 3, SearchType.All,
                                    slab_chars=300, checkpoint_path=ck,
                                    mesh=_mesh(3), **CPU) == full
    for mesh in (_mesh(4), None):
        seeded = SweepCheckpoint.load_or_create(ck)
        seeded.advance(600, [mt for mt in full if mt.end <= 600])
        kw = CPU if mesh is None else dict(mesh=mesh, **CPU)
        assert levenshtein_search_sweep(needle, hay, 3, SearchType.All,
                                        slab_chars=300, checkpoint_path=ck,
                                        **kw) == full


def test_hamming_search_sharded_equals_jax():
    needle, hay = _input(34, 400, 9, [44, 100 - 4, 200 - 8, 396], alpha=3)
    for st in MODES:
        ref = jh.hamming_search_sharded(needle, hay, 3,
                                        jax_mesh(jax.devices()[:4]),
                                        JSearchType[st.name])
        want = th.hamming_search_simd_with_opts(needle, hay, 3, st, **CPU)
        assert _tuples(want) == _tuples(ref)
        for D in (1, 4, 7):
            assert th.hamming_search_sharded(needle, hay, 3, _mesh(D), st,
                                             **CPU) == want, (st, D)
