"""The PyTorch/CUDA port as a whole, on the CPU.

Every public function the port carries is run with device="cpu" (so the
kernels' plain PyTorch versions compute) and must equal, exactly, the
same-named function of the JAX package on its default CPU path and the
scalar oracle.  Also: the dispatch log names the engine, every route that
was not ported raised NotImplementedError until its engine was ported,
and now returns the reference's results (the `mesh=` routes on a CPU
mesh, against the meshless call), and
results do not depend on the native host library.  The general-cost and traced distance routes have
their own files (test_torch_band_distance.py, test_torch_band_trace.py),
Hamming has test_torch_hamming.py.
"""

import importlib

import numpy as np
import pytest
import torch

import chip_smoke as cs
from triple_accel_tpu.oracle import (
    levenshtein_naive_k,
    levenshtein_search_naive_with_opts,
)

import triple_accel_tpu_torch as tt
from triple_accel_tpu_torch.dispatch import (
    dispatch_history,
    last_dispatch,
)
from triple_accel_tpu_torch.types import (
    EditCosts,
    LEVENSHTEIN_COSTS,
    Match,
    RDAMERAU_COSTS,
    SearchType,
)
from triple_accel_tpu.types import (
    EditCosts as JEditCosts,
    LEVENSHTEIN_COSTS as J_LEV,
    RDAMERAU_COSTS as J_RDAM,
    SearchType as JSearchType,
)

# one intra-op thread: the test workers run side by side on the
# machine's cores
torch.set_num_threads(1)

# the packages' top-level `levenshtein` names are the blessed functions, so
# the submodules are fetched by their dotted names
jl = importlib.import_module("triple_accel_tpu.levenshtein")
tl = importlib.import_module("triple_accel_tpu_torch.levenshtein")

CPU = dict(device="cpu")


def _as_tuples(matches):
    return [(m.start, m.end, m.k) for m in matches]


def _mixed_batch(rng, n):
    """Mixed lengths (several pow2 buckets), edits, infeasible pairs (length
    gap above k) and both-empty pairs."""
    a_list, b_list = [], []
    for p in range(n):
        ln = int(rng.choice([0, 5, 12, 30, 70, 130]))
        ln = max(0, ln + int(rng.integers(-3, 4)))
        a = rng.integers(65, 70, ln).astype(np.uint8)
        b = a.copy()
        if ln > 4:
            b[rng.integers(0, ln, 2)] = 65
            if p % 3 == 0:
                b = np.delete(b, rng.integers(0, len(b), 2))
        if p % 17 == 0:
            b = np.concatenate([b, rng.integers(65, 70, 20).astype(np.uint8)])
        if p % 2:
            a, b = b, a
        a_list.append(a)
        b_list.append(b)
    a_list[0] = b_list[0] = np.empty(0, np.uint8)
    return a_list, b_list


def test_k_batch_bucketed_equals_jax_and_oracle():
    rng = np.random.default_rng(11)
    a_list, b_list = _mixed_batch(rng, 700)  # > _MIN_BUCKET: recursion runs
    assert len(a_list) > tl._MIN_BUCKET
    dispatch_history(clear=True)
    got = tl.levenshtein_k_batch(a_list, b_list, 6, **CPU)
    launches = [d for _, d in dispatch_history()]
    assert len(launches) > 1 and {d.path for d in launches} == {"myers"}
    ref = jl.levenshtein_k_batch(a_list, b_list, 6)
    assert got.dtype == np.int64 and got.tolist() == np.asarray(ref).tolist()
    exp = [levenshtein_naive_k(a, b, 6) for a, b in zip(a_list, b_list)]
    assert got.tolist() == [-1 if e is None else e for e in exp]
    assert (got == -1).any() and got[0] == 0


def test_k_batch_small_and_empty():
    got = tl.levenshtein_k_batch([b"kitten", b"", b"abc"],
                                 [b"sitting", b"", b"abcdefghij"], 3, **CPU)
    assert got.tolist() == [3, 0, -1]
    assert last_dispatch().path == "myers"
    assert tl.levenshtein_k_batch([], [], 3, **CPU).shape == (0,)
    with pytest.raises(ValueError):
        tl.levenshtein_k_batch([b"a"], [], 3, **CPU)


def test_negative_threshold_answers_like_jax_and_oracle():
    got = tl.levenshtein_k_batch([b"abc", b""], [b"abd", b"q"], -1, **CPU)
    assert last_dispatch().path == "myers"
    assert got.tolist() == [-1, -1] == np.asarray(
        jl.levenshtein_k_batch([b"abc", b""], [b"abd", b"q"], -1)).tolist()
    assert tl.levenshtein_simd_k(b"abc", b"abc", -1, **CPU) is None
    assert jl.levenshtein_simd_k(b"abc", b"abc", -1) is None
    assert levenshtein_naive_k(b"abc", b"abc", -1) is None
    # a mixed batch (equal, empty, one-off and infeasible pairs) under every
    # cost model, traced and not: -1 / None everywhere, as in the reference
    a_list, b_list = _mixed_batch(np.random.default_rng(3), 40)
    for costs, jcosts in ((LEVENSHTEIN_COSTS, J_LEV), (RDAMERAU_COSTS, J_RDAM),
                          (EditCosts(2, 1, 2), JEditCosts(2, 1, 2))):
        for trace in (False, True):
            got = tl.levenshtein_k_batch(a_list, b_list, -1, costs, trace,
                                         **CPU)
            ref = jl.levenshtein_k_batch(a_list, b_list, -1, jcosts, trace)
            if trace:
                assert got[1] == [None] * 40 and list(ref[1]) == [None] * 40
                got, ref = got[0], ref[0]
            assert got.tolist() == [-1] * 40 == np.asarray(ref).tolist()


@pytest.mark.parametrize("a,b", [
    (b"abc", b"ab"), (b"", b""), (b"", b"abc"), (b"kitten", b"sitting"),
    (b"abcdefghijklmnopqrstuvwxyz" * 3, b"zyx" * 20),
])
def test_single_pair_wrappers_equal_jax(a, b):
    assert tl.levenshtein(a, b, **CPU) == jl.levenshtein(a, b)
    assert tl.levenshtein_exp(a, b, **CPU) == jl.levenshtein_exp(a, b)
    assert tt.levenshtein(a, b, **CPU) == jl.levenshtein(a, b)
    for k in (0, 2, 40):
        assert tl.levenshtein_simd_k(a, b, k, **CPU) == jl.levenshtein_simd_k(
            a, b, k)
    assert tl.levenshtein_simd_k_with_opts(a, b, 40, False, **CPU) == \
        jl.levenshtein_simd_k_with_opts(a, b, 40, False)
    assert tl.levenshtein_exp_with_opts(a, b, **CPU) == \
        jl.levenshtein_exp_with_opts(a, b)


def test_exp_batch_and_str_wrappers_equal_jax():
    rng = np.random.default_rng(3)
    a_list = [rng.integers(65, 91, int(rng.integers(0, 90))).astype(np.uint8)
              for _ in range(40)]
    b_list = [rng.integers(65, 91, int(rng.integers(0, 90))).astype(np.uint8)
              for _ in range(40)]
    got = tl.levenshtein_exp_batch(a_list, b_list, **CPU)
    ref = jl.levenshtein_exp_batch(a_list, b_list)
    assert got.tolist() == np.asarray(ref).tolist() and (got >= 0).all()
    for a, b, k in [("abc", "ab", 1), ("héllo wörld", "hello world", 3),
                    ("日本語のテキスト", "日本語テキスト!", 2)]:
        assert tl.levenshtein_simd_k_str(a, b, k, **CPU) == \
            jl.levenshtein_simd_k_str(a, b, k)
        assert tl.levenstein_naive_str(a, b) == jl.levenstein_naive_str(a, b)
    chars_t, chars_j = [], []
    assert tl.translate_str(chars_t, "añb").tolist() == \
        jl.translate_str(chars_j, "añb").tolist()


@pytest.mark.parametrize("anchored", [False, True])
@pytest.mark.parametrize("damerau", [False, True])
@pytest.mark.parametrize("st_name", ["Best", "All"])
def test_search_equals_jax_and_oracle(st_name, damerau, anchored):
    st, jst = SearchType[st_name], JSearchType[st_name]
    costs, jcosts = ((RDAMERAU_COSTS, J_RDAM) if damerau
                     else (LEVENSHTEIN_COSTS, J_LEV))
    rng = np.random.default_rng(7 + damerau + 2 * anchored)
    for trial in range(6):
        m = int(rng.integers(1, 24)) if trial else 70  # one multi-word
        n = int(rng.integers(0, 220))
        needle = rng.integers(65, 70, m).astype(np.uint8)
        hay = rng.integers(65, 70, n).astype(np.uint8)
        if n > m and trial % 2 == 0:
            pos = 0 if anchored else int(rng.integers(0, n - m))
            hay[pos:pos + m] = needle  # plant an exact match
        k = int(rng.integers(0, max(m // 2, 1) + 1))
        got = tl.levenshtein_search_simd_with_opts(
            needle, hay, k, st, costs, anchored, **CPU)
        assert last_dispatch().path == (
            "myers_search_rdamerau" if damerau else "myers_search")
        exp = levenshtein_search_naive_with_opts(
            needle, hay, k, jst, jcosts, anchored)
        assert _as_tuples(got) == _as_tuples(exp), (trial, m, n, k)
        if trial < 2:  # the JAX scan path compiles per shape: two suffice
            ref = jl.levenshtein_search_simd_with_opts(
                needle, hay, k, jst, jcosts, anchored)
            assert _as_tuples(got) == _as_tuples(ref), (trial, m, n, k)


def test_blessed_search_and_empty_needles():
    assert tt.levenshtein_search(b"helllo", b"hello world", **CPU) == [
        Match(start=0, end=5, k=1)]
    assert _as_tuples(tl.levenshtein_search(b"abc", b"  abd", **CPU)) == \
        _as_tuples(jl.levenshtein_search(b"abc", b"  abd"))
    assert _as_tuples(tl.levenshtein_search_simd(b"abc", b"", **CPU)) == \
        _as_tuples(jl.levenshtein_search_simd(b"abc", b""))
    for anchored in (False, True):
        for st, jst in ((SearchType.Best, JSearchType.Best),
                        (SearchType.All, JSearchType.All)):
            got = tl.levenshtein_search_simd_with_opts(
                b"", b"abcdef", 3, st, LEVENSHTEIN_COSTS, anchored, **CPU)
            ref = jl.levenshtein_search_simd_with_opts(
                b"", b"abcdef", 3, jst, J_LEV, anchored)
            assert _as_tuples(got) == _as_tuples(ref)
    with pytest.raises(ValueError, match="transpose_cost"):
        tl.levenshtein_search_simd_with_opts(
            b"ab", b"abc", 1, SearchType.Best, EditCosts(1, 1, 0, 3),
            **CPU)  # check_search runs before any dispatch


def test_nul_bytes_are_legal_inputs():
    needle = np.array([0, 65, 0, 66], np.uint8)
    hay = np.concatenate([np.zeros(3, np.uint8),
                          np.frombuffer(b"xxA\x00Byy", np.uint8), needle])
    for st in (SearchType.All, SearchType.Best):
        got = tl.levenshtein_search_simd_with_opts(needle, hay, 2, st, **CPU)
        exp = levenshtein_search_naive_with_opts(
            needle, hay, 2, JSearchType[st.name], J_LEV, False)
        assert _as_tuples(got) == _as_tuples(exp)
    assert tl.levenshtein(b"a\x00b", b"ab\x00", **CPU) == 2


_LONG_A = np.full(4150, 65, np.uint8)  # unit_k past the plan's 4096
_LONG_B = np.full(4150, 66, np.uint8)


# Seven routes raised here until their engines were ported (K7
# search_diag, K8 flat_search, K9 flat_distance; the traced band kernel's
# device-memory regime with the walk K10); their cases keep their ids and
# now hold the route's result against a reference (engine None).
def _long_traced_pair(seed):
    """The shortest pairs past the band plan at an unbounded threshold (n =
    4,700: a traced batch's unit_k 4,704, band 9,409, past a block's
    shared memory): ACGT, substitutions and adjacent swaps."""
    rng = np.random.default_rng(seed)
    a = cs.ACGT[rng.integers(0, 4, 4700)]
    b = a.copy()
    b[rng.integers(0, 4700, 30)] = cs.ACGT[rng.integers(0, 4, 30)]
    for q in rng.integers(0, 4699, 6).tolist():
        b[q], b[q + 1] = b[q + 1], b[q]
    return a, b


def _check_traced_long(dist, edits, a, b, k, costs):
    from triple_accel_tpu_torch.utils.native import (
        scalar_banded_batch_native)

    assert last_dispatch().path == "band_trace_global"
    assert last_dispatch().unit_k == 4704
    assert dist == int(scalar_banded_batch_native([a], [b], k, costs)[0])
    assert cs.replay_cost(a, b, edits, costs) == dist > 0


def _levenshtein_past_band_plan():
    a, b = _long_traced_pair(1)
    d, traces = tl.levenshtein_k_batch([a], [b], tl.U32_MAX, trace_on=True,
                                       **CPU)
    _check_traced_long(int(d[0]), traces[0], a, b, tl.U32_MAX,
                       LEVENSHTEIN_COSTS)


def _rdamerau_past_band_plan():
    a, b = _long_traced_pair(2)
    d, edits = tl.levenshtein_simd_k_with_opts(a, b, tl.U32_MAX, True,
                                               RDAMERAU_COSTS, **CPU)
    _check_traced_long(d, edits, a, b, tl.U32_MAX, RDAMERAU_COSTS)


def _trace_past_band_plan():
    a, b = _long_traced_pair(3)
    d, edits = tl.levenshtein_simd_k_with_opts(a, b, 10**6, True, **CPU)
    _check_traced_long(d, edits, a, b, 10**6, LEVENSHTEIN_COSTS)


def _affine_past_band_plan():
    from triple_accel_tpu_torch.utils.native import (
        scalar_banded_batch_native)

    a, b = _LONG_A, _LONG_B
    costs = EditCosts(2, 1, 2, None)
    dispatch_history(clear=True)
    got = tl.levenshtein_k_batch([a], [b], 10**6, costs, **CPU)
    assert dispatch_history()[-1][1].path == "flat_distance"
    assert got.tolist() == scalar_banded_batch_native(
        [a], [b], 10**6, costs).tolist() == [8300]


def _search_general_costs():
    costs = EditCosts(2, 1, 0, None)
    for st in (SearchType.All, SearchType.Best):
        got = tl.levenshtein_search_simd_with_opts(b"abc", b"xxabcxx", 1,
                                                   st, costs, **CPU)
        assert _as_tuples(got) == _as_tuples(
            levenshtein_search_naive_with_opts(b"abc", b"xxabcxx", 1,
                                               JSearchType[st.name],
                                               JEditCosts(2, 1, 0, None)))
    assert last_dispatch().path == "search_diag"


def _search_long_needle():
    from triple_accel_tpu_torch.utils.native import search_all_native

    needle = b"a" * 1281  # past K2's 1280 chars and K7's 512
    hay = b"b" * 10 + needle + b"b" * 10
    costs = EditCosts(1, 2, 1, None)
    got = tl.levenshtein_search_simd_with_opts(needle, hay, 3,
                                               SearchType.All, costs, **CPU)
    assert last_dispatch().path == "flat_search"
    ends, ks, lens = search_all_native(needle, hay, 3, costs)
    assert _as_tuples(got) == list(zip((ends - lens).tolist(),
                                       ends.tolist(), ks.tolist()))
    assert tl.levenshtein_search_simd_with_opts(
        needle, hay, 3, SearchType.Best, costs, **CPU) == [Match(10, 1291, 0)]


def _search_dense_hits():
    from triple_accel_tpu_torch.utils.native import search_all_native

    needle, hay = b"ab" * 20, b"ab" * 600
    saved = tl._RESOLVE_CELLS_BUDGET
    tl._RESOLVE_CELLS_BUDGET = 10_000  # shrunk with the case
    try:
        dispatch_history(clear=True)
        got = tl.levenshtein_search_simd_with_opts(needle, hay, 38,
                                                   SearchType.All, **CPU)
    finally:
        tl._RESOLVE_CELLS_BUDGET = saved
    assert [d.path for _, d in dispatch_history()] == [
        "myers_search", "flat_resolve"]
    ends, ks, lens = search_all_native(needle, hay, 38, LEVENSHTEIN_COSTS)
    assert _as_tuples(got) == list(zip((ends - lens).tolist(),
                                       ends.tolist(), ks.tolist()))


def _cpu_mesh(D=3):
    from triple_accel_tpu_torch.parallel import make_mesh

    return make_mesh(["cpu"] * D)


def _k_batch_mesh():
    a_list, b_list = _mixed_batch(np.random.default_rng(31), 40)
    dispatch_history(clear=True)
    got = tl.levenshtein_k_batch(a_list, b_list, 6, mesh=_cpu_mesh(), **CPU)
    assert [d.path for _, d in dispatch_history()] == ["myers_sharded"]
    assert np.array_equal(got, tl.levenshtein_k_batch(a_list, b_list, 6,
                                                      **CPU))


def _k_batch_traced_mesh():
    a_list, b_list = _mixed_batch(np.random.default_rng(32), 12)
    dispatch_history(clear=True)
    d_m, tr_m = tl.levenshtein_k_batch(a_list, b_list, 6, trace_on=True,
                                       mesh=_cpu_mesh(), **CPU)
    assert [d.path for _, d in dispatch_history()] == [
        "trace_mesh_ignored", "band_trace"]
    d_1, tr_1 = tl.levenshtein_k_batch(a_list, b_list, 6, trace_on=True,
                                       **CPU)
    assert np.array_equal(d_m, d_1) and tr_m == tr_1


def _search_inputs():
    rng = np.random.default_rng(33)
    needle = rng.integers(65, 69, 9).astype(np.uint8)
    hay = rng.integers(65, 69, 400).astype(np.uint8)
    hay[130:139] = needle  # straddles the shard edge at 134
    return needle, hay


def _search_many_mesh():
    needle, hay = _search_inputs()
    needles = [needle, hay[10:17].copy(), b"", needle[:4]]
    for st in (SearchType.Best, SearchType.All):
        got = tl.levenshtein_search_many(needles, hay, 2, st,
                                         mesh=_cpu_mesh(), **CPU)
        assert got == tl.levenshtein_search_many(needles, hay, 2, st, **CPU)


def _packed_haystack_mesh():
    needle, hay = _search_inputs()
    ph = tl.PackedHaystack(hay, **CPU)
    mesh = _cpu_mesh()
    wins = ph.pack_sharded(mesh, 16)
    assert ph.uploads == 3 and ph.pack_sharded(mesh, 12) is wins
    assert [w.shape[0] for w in wins.windows] == [134, 150, 148]
    got = tl.levenshtein_search_many([needle], ph, 2, SearchType.All,
                                     mesh=mesh, **CPU)
    assert ph.uploads == 3
    assert got[0] == tl.levenshtein_search_simd_with_opts(
        needle, hay, 2, SearchType.All, **CPU)


def _search_sharded():
    needle, hay = _search_inputs()
    for st in (SearchType.Best, SearchType.All):
        got = tl.levenshtein_search_sharded(needle, hay, 2, _cpu_mesh(), st,
                                            **CPU)
        assert got == tl.levenshtein_search_simd_with_opts(needle, hay, 2,
                                                           st, **CPU)
        assert _as_tuples(got) == _as_tuples(
            levenshtein_search_naive_with_opts(
                needle, hay, 2, JSearchType[st.name], J_LEV, False))


def _hamming_search_sharded():
    needle, hay = _search_inputs()
    got = tt.hamming_search_sharded(needle, hay, 3, _cpu_mesh(),
                                    SearchType.All, **CPU)
    ref = importlib.import_module("triple_accel_tpu_torch.hamming") \
        .hamming_search_simd_with_opts(needle, hay, 3, SearchType.All, **CPU)
    assert got == ref and any(mt.start == 130 and mt.k == 0 for mt in got)


@pytest.mark.parametrize("call,engine", [
    (_k_batch_mesh, None),
    (_k_batch_traced_mesh, None),
    # past the band plan (band half-width over 4096) every cost model has
    # an engine, traced or not
    (_levenshtein_past_band_plan, None),
    (_rdamerau_past_band_plan, None),
    (_affine_past_band_plan, None),
    (_trace_past_band_plan, None),
    (_search_general_costs, None),
    (_search_long_needle, None),
    (_search_dense_hits, None),
    # the mesh routes, on a CPU mesh of 3 shards against the meshless call
    (_search_many_mesh, None),
    (_packed_haystack_mesh, None),
    (_search_sharded, None),
    (_hamming_search_sharded, None),
], ids=[
    "k_batch_mesh", "k_batch_traced_mesh", "levenshtein_past_band_plan",
    "rdamerau_past_band_plan", "affine_past_band_plan",
    "trace_past_band_plan", "search_general_costs", "search_long_needle",
    "search_dense_hits", "search_many", "packed_haystack", "search_sharded",
    "hamming_search_sharded",
])
def test_unported_routes_raise(call, engine):
    """Every route that raised NotImplementedError until its engine was
    ported now checks its results (engine None for each: no route of the
    JAX package is left unported)."""
    assert engine is None
    call()


def test_forced_oracle_and_debug_log(monkeypatch, capsys):
    monkeypatch.setenv("TRIPLE_ACCEL_TORCH_FORCE_PATH", "oracle")
    assert tl.rdamerau(b"abc", b"acb", **CPU) == 1
    d_t, tr_t = tl.levenshtein_simd_k_with_opts(b"ab", b"ba", 2, True, **CPU)
    d_j, tr_j = jl.levenshtein_simd_k_with_opts(b"ab", b"ba", 2, True)
    assert d_t == d_j  # each package has its own Edit type: compare fields
    assert [(e.edit.name, e.count) for e in tr_t] == [
        (e.edit.name, e.count) for e in tr_j]
    monkeypatch.setenv("TRIPLE_ACCEL_TORCH_FORCE_PATH", "kernel")
    monkeypatch.setenv("TRIPLE_ACCEL_TORCH_DEBUG_DISPATCH", "1")
    assert tl.levenshtein_simd_k(b"abc", b"ab", 1, **CPU) == 1
    assert "path=myers" in capsys.readouterr().err


def test_results_do_not_depend_on_the_native_library(monkeypatch):
    from triple_accel_tpu_torch.utils.native import native_available

    rng = np.random.default_rng(21)
    needle = rng.integers(65, 68, 8).astype(np.uint8)
    hay = rng.integers(65, 68, 300).astype(np.uint8)
    hay[40:48] = needle

    def run():
        return [
            _as_tuples(tl.levenshtein_search_simd_with_opts(
                needle, hay, 2, st, costs, anchored, **CPU))
            for st in (SearchType.Best, SearchType.All)
            for costs in (LEVENSHTEIN_COSTS, RDAMERAU_COSTS)
            for anchored in (False, True)
        ] + [tl.postprocess_matches(
            np.array([5, 1, 0, 1, 5]), np.array([0, 1, 2, 3, 4]), 1, st)
            for st in (SearchType.Best, SearchType.All)]

    with_native = run()
    monkeypatch.setenv("TRIPLE_ACCEL_TORCH_NO_NATIVE", "1")
    assert not native_available()
    assert run() == with_native
