"""Dictionary search of the PyTorch/CUDA port (`levenshtein_search_many`,
`PackedHaystack`), on the CPU.

The port runs with device="cpu" (the kernels' plain PyTorch versions) and
must equal, exactly, the JAX package's `levenshtein_search_many` on its
default CPU path, the scalar oracle, and the port's own single-needle
`levenshtein_search_simd_with_opts` for every needle.  The inputs: a
800-byte haystack over four letters and needles of 24, 5, 400, 9, 0 and
5 chars (the 400-char one is the K6 group), each planted once with one
substitution, under unit and rDamerau costs, and the same needles but the
400-char one under `EditCosts(2, 1, 2)` (a needle at a time there, as the
single call runs it; the plain diagonal kernel takes about 0.5 s a
needle), Best and All.  Also: the dispatch log (one
`myers_search_many*` entry a launch, the general-cost needles one by one),
one upload for a `PackedHaystack` reused across calls, the snapshot taken
at construction, a launch budget forced small, the launch plan's limits,
the dense-hit route over the resident haystack, and the routes that raise.
"""

import functools
import importlib

import numpy as np
import pytest
import torch

from triple_accel_tpu.oracle import levenshtein_search_naive_with_opts
from triple_accel_tpu.types import (
    EditCosts as JEditCosts,
    SearchType as JSearchType,
)

from triple_accel_tpu_torch.dispatch import dispatch_history
from triple_accel_tpu_torch.types import (
    EditCosts,
    LEVENSHTEIN_COSTS,
    RDAMERAU_COSTS,
    SearchType,
)

# one intra-op thread: the test workers run side by side on the
# machine's cores
torch.set_num_threads(1)

jl = importlib.import_module("triple_accel_tpu.levenshtein")
tl = importlib.import_module("triple_accel_tpu_torch.levenshtein")

CPU = dict(device="cpu")
HAY_LEN = 800
LENGTHS = (24, 5, 400, 9, 0, 5)
AFFINE_LENGTHS = (24, 5, 9, 0, 5)
# (name, port costs, JAX costs, k)
COSTS = {
    "unit": (LEVENSHTEIN_COSTS, JEditCosts(1, 1, 0, None), 3),
    "rdamerau": (RDAMERAU_COSTS, JEditCosts(1, 1, 0, 1), 3),
    "affine": (EditCosts(2, 1, 2, None), JEditCosts(2, 1, 2, None), 6),
}
MODES = {"Best": (SearchType.Best, JSearchType.Best),
         "All": (SearchType.All, JSearchType.All)}


def _as_tuples(lists):
    return [[(m.start, m.end, m.k) for m in ms] for ms in lists]


def _inputs(seed: int = 12, lengths=LENGTHS, n: int = HAY_LEN):
    """Needles over ACGT and a haystack of ACGT noise with every non-empty
    needle planted once, with one substitution, at places that do not
    overlap."""
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    hay = acgt[rng.integers(0, 4, n)]
    needles = [acgt[rng.integers(0, 4, m)] for m in lengths]
    pos = 20
    for nd in needles:
        if len(nd) == 0:
            continue
        copy = nd.copy()
        q = int(rng.integers(0, len(nd)))
        copy[q] = acgt[(np.flatnonzero(acgt == copy[q])[0] + 1) % 4]
        hay[pos: pos + len(nd)] = copy
        pos += len(nd) + 37
    assert pos <= n
    return needles, hay


@functools.lru_cache(maxsize=None)
def _port_many(cname: str, mode: str):
    """The port's dictionary call on the main inputs and its dispatch log
    (each case runs once per test process)."""
    costs, _, k = COSTS[cname]
    needles, hay = _case_inputs(cname)
    dispatch_history(clear=True)
    got = tl.levenshtein_search_many(needles, hay, k, MODES[mode][0], costs,
                                     **CPU)
    return _as_tuples(got), [(r, d.path) for r, d in dispatch_history()]


def _case_inputs(cname: str):
    needles, hay = _inputs()
    if cname == "affine":
        needles = [nd for nd in needles if len(nd) in AFFINE_LENGTHS]
    return needles, hay


CASES = [(c, md) for c in COSTS for md in MODES]
IDS = [f"{c}-{md}" for c, md in CASES]


@pytest.mark.parametrize("cname,mode", CASES, ids=IDS)
def test_search_many_matches_the_jax_function(cname, mode):
    costs, jcosts, k = COSTS[cname]
    needles, hay = _case_inputs(cname)
    got, log = _port_many(cname, mode)
    ref = jl.levenshtein_search_many(needles, hay, k, MODES[mode][1], jcosts)
    assert got == _as_tuples(ref)
    # every planted copy is found, at most one substitution away
    for ms, nd in zip(got, needles):
        assert bool(ms) == (len(nd) > 0)
        assert len(nd) == 0 or min(t[2] for t in ms) <= costs.mismatch_cost
    if cname == "affine":  # needle by needle, as the single call logs
        assert log == [("levenshtein_search_simd_with_opts",
                        "search_diag")] * 4
    else:  # one launch a length group, in length order
        assert log == [("levenshtein_search_many", "myers_search_many")] * 3 \
            + [("levenshtein_search_many", "myers_search_many_blocked")]


@pytest.mark.parametrize("cname,mode", CASES, ids=IDS)
def test_search_many_matches_the_oracle(cname, mode):
    _, jcosts, k = COSTS[cname]
    needles, hay = _case_inputs(cname)
    got, _ = _port_many(cname, mode)
    ref = [levenshtein_search_naive_with_opts(nd, hay, k, MODES[mode][1],
                                              jcosts, False)
           for nd in needles]
    assert got == _as_tuples(ref)


@pytest.mark.parametrize("cname,mode", [("unit", "Best"),
                                        ("rdamerau", "All")],
                         ids=["unit-Best", "rdamerau-All"])
def test_search_many_equals_the_single_calls(cname, mode):
    costs, _, k = COSTS[cname]
    needles, hay = _inputs()
    got, _ = _port_many(cname, mode)
    single = [tl.levenshtein_search_simd_with_opts(
        nd, hay, k, MODES[mode][0], costs, False, **CPU) for nd in needles]
    assert got == _as_tuples(single)


def test_packed_haystack_is_uploaded_once_across_calls():
    needles, hay = _inputs(5, (9, 24, 9, 5))
    ph = tl.PackedHaystack(hay, **CPU)
    assert len(ph) == HAY_LEN and ph.uploads == 0
    assert np.array_equal(ph.haystack, hay)
    first = tl.levenshtein_search_many(needles, ph, 3, SearchType.All, **CPU)
    second = tl.levenshtein_search_many(needles, ph, 3, SearchType.Best,
                                        RDAMERAU_COSTS, **CPU)
    general = tl.levenshtein_search_many(needles[3:], ph, 6, SearchType.All,
                                         COSTS["affine"][0], **CPU)
    assert ph.uploads == 1
    assert ph.device_haystack() is ph.device_haystack()
    assert _as_tuples(first) == _as_tuples(
        [levenshtein_search_naive_with_opts(nd, hay, 3, JSearchType.All,
                                            COSTS["unit"][1], False)
         for nd in needles])
    assert _as_tuples(second) == _as_tuples(
        [levenshtein_search_naive_with_opts(nd, hay, 3, JSearchType.Best,
                                            COSTS["rdamerau"][1], False)
         for nd in needles])
    assert general[0] == tl.levenshtein_search_simd_with_opts(
        needles[3], hay, 6, SearchType.All, COSTS["affine"][0], **CPU)


def test_packed_haystack_is_a_snapshot():
    """The JAX package's PackedHaystack keeps the caller's array; the port
    copies it at construction, as both docstrings promise."""
    needles, hay = _inputs(6, (9, 5))
    src = hay.copy()
    ph = tl.PackedHaystack(src, **CPU)
    before = tl.levenshtein_search_many(needles, ph, 2, SearchType.All, **CPU)
    src[:] = ord("N")  # no needle byte: nothing would match any more
    assert np.array_equal(ph.haystack, hay)
    after = tl.levenshtein_search_many(needles, ph, 2, SearchType.All, **CPU)
    fresh = tl.PackedHaystack(hay, **CPU)
    src2 = hay.copy()
    ph2 = tl.PackedHaystack(src2, **CPU)
    src2[:] = ord("N")  # mutated before the first search and its upload
    assert before == after and before[0]
    assert _as_tuples(tl.levenshtein_search_many(
        needles, ph2, 2, SearchType.All, **CPU)) == _as_tuples(
        tl.levenshtein_search_many(needles, fresh, 2, SearchType.All, **CPU))


def test_a_small_budget_splits_a_group_into_launches(monkeypatch):
    needles, hay = _inputs(7, (9,) * 7)
    whole = tl.levenshtein_search_many(needles, hay, 3, SearchType.All, **CPU)
    per_needle = 4 * (HAY_LEN + 32) + HAY_LEN + 1
    monkeypatch.setattr(tl, "_MANY_LAUNCH_BYTES", 3 * per_needle)
    dispatch_history(clear=True)
    split = tl.levenshtein_search_many(needles, hay, 3, SearchType.All, **CPU)
    log = [(r, d.path, d.padded_n) for r, d in dispatch_history()]
    assert log == [("levenshtein_search_many", "myers_search_many", c)
                   for c in (3, 3, 1)]
    assert split == whole
    assert _as_tuples(split) == _as_tuples(
        [levenshtein_search_naive_with_opts(nd, hay, 3, JSearchType.All,
                                            JEditCosts(1, 1, 0, None), False)
         for nd in needles])


def test_the_launch_plan(monkeypatch):
    plan = tl._many_launch_plan
    monkeypatch.setattr(tl, "_MANY_LAUNCH_BYTES", 1 << 50)
    # nonzero's 2^31 - 1 elements: 15 needles a launch at 128 MiB, 32,767
    # at 64 KiB
    assert plan(40, 128 << 20, False, 32, 2048) == [(0, 15), (15, 30),
                                                    (30, 40)]
    assert plan(32769, 65535, False, 32, 256) == [(0, 32767),
                                                  (32767, 32769)]
    # a launch's grid takes at most 65,535 needles
    assert plan(70000, 100, False, 32, 256) == [(0, 65535), (65535, 70000)]
    # device memory: int32 distances (rows padded), the mask, and K6's
    # strips' boundary rows (4 segments of 256 owned and 32 halo bytes)
    k2 = 4 * (1000 + 32) + 1001
    k6 = k2 + 4 * (32 + 256 + 16)
    monkeypatch.setattr(tl, "_MANY_LAUNCH_BYTES", 10 * k2)
    assert plan(25, 1000, False, 32, 256) == [(0, 10), (10, 20), (20, 25)]
    assert plan(25, 1000, True, 32, 256) == [(0, 8), (8, 16), (16, 24),
                                             (24, 25)]
    monkeypatch.setattr(tl, "_MANY_LAUNCH_BYTES", 10 * k6)
    assert plan(25, 1000, True, 32, 256)[0] == (0, 10)
    # at least one needle a launch
    monkeypatch.setattr(tl, "_MANY_LAUNCH_BYTES", 1)
    assert plan(2, 1000, True, 32, 256) == [(0, 1), (1, 2)]


def test_dense_hits_take_the_flat_route_over_the_resident_haystack(
        monkeypatch):
    needles = [b"ab" * 20, b"ba" * 20]
    hay = b"ab" * 600
    ph = tl.PackedHaystack(hay, **CPU)
    monkeypatch.setattr(tl, "_RESOLVE_CELLS_BUDGET", 10_000)
    dispatch_history(clear=True)
    got = tl.levenshtein_search_many(needles, ph, 38, SearchType.All, **CPU)
    assert [d.path for _, d in dispatch_history()] == [
        "myers_search_many", "flat_resolve", "flat_resolve"]
    assert ph.uploads == 1
    monkeypatch.undo()
    for nd, ms in zip(needles, got):
        assert _as_tuples([ms]) == _as_tuples([
            levenshtein_search_naive_with_opts(
                nd, hay, 38, JSearchType.All, JEditCosts(1, 1, 0, None),
                False)])


def test_empty_needles_and_an_empty_haystack():
    for costs in (LEVENSHTEIN_COSTS, COSTS["affine"][0]):
        for hay in (b"", b"xxabxx"):
            for st in (SearchType.Best, SearchType.All):
                needles = [b"", b"ab", b"a"]
                got = tl.levenshtein_search_many(needles, hay, 4, st, costs,
                                                 **CPU)
                assert got == [tl.levenshtein_search_simd_with_opts(
                    nd, hay, 4, st, costs, False, **CPU) for nd in needles]
    assert tl.levenshtein_search_many([], b"abc", 1, **CPU) == []


def test_forced_oracle_path(monkeypatch):
    needles, hay = _inputs(8, (9, 24))
    want = tl.levenshtein_search_many(needles, hay, 3, SearchType.All, **CPU)
    monkeypatch.setenv("TRIPLE_ACCEL_TORCH_FORCE_PATH", "oracle")
    dispatch_history(clear=True)
    assert tl.levenshtein_search_many(needles, hay, 3, SearchType.All,
                                      **CPU) == want
    assert dispatch_history() == []


def test_mesh_and_a_device_mismatch_raise():
    from triple_accel_tpu_torch.parallel import make_mesh

    needles, hay = _inputs(8, (9, 24))
    mesh = make_mesh(["cpu"] * 3)
    ph = tl.PackedHaystack(hay, **CPU)
    for st in (SearchType.Best, SearchType.All):
        dispatch_history(clear=True)
        got = tl.levenshtein_search_many(needles, ph, 3, st, mesh=mesh, **CPU)
        assert {d.path for _, d in dispatch_history()} == {
            "myers_search_many_sharded"}
        assert got == tl.levenshtein_search_many(needles, hay, 3, st, **CPU)
    assert ph.uploads == 3  # one pack: a device's window each
    ph = tl.PackedHaystack(b"abab", **CPU)
    ph.device = torch.device("cuda", 0)  # as if built on a card
    with pytest.raises(ValueError, match="PackedHaystack lies on"):
        tl.levenshtein_search_many([b"ab"], ph, 1, mesh=mesh, **CPU)
    with pytest.raises(ValueError, match="PackedHaystack lies on"):
        tl.levenshtein_search_many([b"ab"], ph, 1, **CPU)
    assert ph.uploads == 0
