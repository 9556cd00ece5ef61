"""The PyTorch/CUDA port as a whole, on the CPU.

Every public function the port carries is run with device="cpu" (so the
kernels' plain PyTorch versions compute) and must equal, exactly, the
same-named function of the JAX package on its default CPU path and the
scalar oracle.  Also: the dispatch log names the engine, every route that
is not ported raises NotImplementedError, and results do not depend on the
native host library.  The general-cost and traced distance routes have
their own files (test_torch_band_distance.py, test_torch_band_trace.py),
Hamming has test_torch_hamming.py.
"""

import importlib

import numpy as np
import pytest

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
    LEVENSHTEIN_COSTS as J_LEV,
    RDAMERAU_COSTS as J_RDAM,
    SearchType as JSearchType,
)

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


_LONG_A = np.full(9000, 65, np.uint8)
_LONG_B = np.full(9000, 66, np.uint8)


@pytest.mark.parametrize("call,engine", [
    (lambda: tl.levenshtein_k_batch([b"ab"], [b"ba"], 2, mesh=object(),
                                    **CPU), "sharded"),
    (lambda: tl.levenshtein_k_batch([b"ab"], [b"ba"], 2, trace_on=True,
                                    mesh=object(), **CPU), "sharded"),
    # past the band plan (band half-width over 4096) the JAX engines that
    # take over are still to be ported
    (lambda: tl.levenshtein(_LONG_A, _LONG_B, **CPU), "myers_chunked"),
    (lambda: tl.rdamerau(_LONG_A, _LONG_B, **CPU), "myers_chunked"),
    (lambda: tl.levenshtein_k_batch([_LONG_A], [_LONG_B], 10**6,
                                    EditCosts(2, 1, 2, None), **CPU),
     "search_flat"),
    (lambda: tl.levenshtein_simd_k_with_opts(_LONG_A, _LONG_B, 10**6, True,
                                             **CPU), "band_scan"),
    (lambda: tl.levenshtein_search_simd_with_opts(
        b"abc", b"xxabcxx", 1, SearchType.All, EditCosts(2, 1, 0, None),
        **CPU), "search_flat"),
    (lambda: tl.levenshtein_search_simd_with_opts(
        b"a" * 1281, b"b" * 2000, 1, **CPU), "blocked_search"),
    (lambda: tl.levenshtein_search_simd_with_opts(
        b"ab" * 200, b"ab" * 600_000, 398, SearchType.All, **CPU),
     "_resolve_hits_flat"),
    (lambda: tl.levenshtein_search_many([b"ab"], b"abab", 1), "search_many"),
    (lambda: tl.PackedHaystack(b"abab"), "PackedHaystack"),
    (lambda: tl.levenshtein_search_sharded(b"ab", b"abab", 1), "sharded"),
    (lambda: tt.hamming_search_sharded(b"ab", b"abab", 1, None), "hamming"),
], ids=[
    "k_batch_mesh", "k_batch_traced_mesh", "levenshtein_past_band_plan",
    "rdamerau_past_band_plan", "affine_past_band_plan",
    "trace_past_band_plan", "search_general_costs", "search_long_needle",
    "search_dense_hits", "search_many", "packed_haystack", "search_sharded",
    "hamming_search_sharded",
])
def test_unported_routes_raise(call, engine):
    with pytest.raises(NotImplementedError, match=engine):
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
