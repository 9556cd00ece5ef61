"""Hamming distance and search of the PyTorch/CUDA port, on the CPU.

Every entry point is run with device="cpu" and must equal, exactly, the
same-named function of the JAX package and the scalar oracle; the
conformance cases of tests/test_conformance_hamming.py (values verbatim from
the reference crate) are run against the port too.  Each package has its own
`Match` type, so matches are compared field by field.
"""

import importlib

import numpy as np
import pytest
import torch

from triple_accel_tpu.types import SearchType as JSearchType

import triple_accel_tpu_torch as tt
from triple_accel_tpu_torch.dispatch import last_dispatch
from triple_accel_tpu_torch.ops import hamming_ops as tho
from triple_accel_tpu_torch.types import Match, SearchType, alloc_str, fill_str

# one intra-op thread: the test workers run side by side on the
# machine's cores
torch.set_num_threads(1)

jh = importlib.import_module("triple_accel_tpu.hamming")
th = importlib.import_module("triple_accel_tpu_torch.hamming")

CPU = dict(device="cpu")

DIST_IMPLS = {
    "hamming_naive": th.hamming_naive,
    "hamming_words_64": th.hamming_words_64,
    "hamming_words_128": th.hamming_words_128,
    "hamming_simd_movemask": lambda a, b: th.hamming_simd_movemask(a, b, **CPU),
    "hamming_simd_parallel": lambda a, b: th.hamming_simd_parallel(a, b, **CPU),
    "hamming": lambda a, b: th.hamming(a, b, **CPU),
    "top_level_hamming": lambda a, b: tt.hamming(a, b, **CPU),
}


def _tuples(matches):
    return [(m.start, m.end, m.k) for m in matches]


@pytest.mark.parametrize("name", sorted(DIST_IMPLS))
def test_basic_hamming(name):
    impl = DIST_IMPLS[name]  # basic_tests.rs:5-16, 74-98 and the doctests
    assert impl(b"abc", b"abd") == 1
    assert impl(b"", b"") == 0
    assert impl(b"abcaaaaaaaaaaaaaaaaaaaaaaaaaaaaaa",
                b"abdaaaaaaaaaaaaaaaaaaaaaaaaaaaaaa") == 1
    a = alloc_str(3)
    fill_str(a, b"abc")
    b = alloc_str(3)
    fill_str(b, b"abd")
    assert impl(a, b) == 1


@pytest.mark.parametrize("name", sorted(DIST_IMPLS))
def test_mismatched_lengths_raise_value_error(name):
    with pytest.raises(ValueError, match="equal lengths"):
        DIST_IMPLS[name](b"abc", b"ab")


def test_hamming_equals_jax_on_random_strings():
    rng = np.random.default_rng(12)
    for ln in (1, 7, 64, 300):
        a = rng.integers(0, 4, ln).astype(np.uint8)  # NUL bytes included
        b = a.copy()
        b[rng.integers(0, ln, ln // 3 + 1)] = 9
        exp = int((a != b).sum())
        assert th.hamming(a, b, **CPU) == jh.hamming(a, b) == exp
        assert th.hamming_words_64(a, b) == th.hamming_words_128(a, b) == exp
    assert last_dispatch().path == "torch"


@pytest.mark.parametrize("variant", ["naive", "simd"])
def test_basic_hamming_search(variant):
    if variant == "naive":
        with_opts, default = (th.hamming_search_naive_with_opts,
                              th.hamming_search_naive)
    else:
        def with_opts(*args):
            return th.hamming_search_simd_with_opts(*args, **CPU)

        def default(*args):
            return th.hamming_search_simd(*args, **CPU)
    a1, b1 = b"abc", b"  abc  abb"  # basic_tests.rs:18-42
    assert with_opts(a1, b1, 1, SearchType.All) == [
        Match(start=2, end=5, k=0), Match(start=7, end=10, k=1)]
    assert default(a1, b1) == [Match(start=2, end=5, k=0)]
    b2 = b"  abc  abb " + b"a" * 60
    assert with_opts(a1, b2, 1, SearchType.All) == [
        Match(start=2, end=5, k=0), Match(start=7, end=10, k=1)]
    assert default(a1, b2) == [Match(start=2, end=5, k=0)]
    assert with_opts(b"abc", b"  abd", 1, SearchType.All) == [
        Match(start=2, end=5, k=1)]
    assert with_opts(b"abcd", b"ab", 1, SearchType.All) == []


def test_blessed_search_entry_points_and_edge_cases():
    assert th.hamming_search(b"abc", b"  abd", **CPU) == [
        Match(start=2, end=5, k=1)]
    assert tt.hamming_search(b"abc", b"  abd", **CPU) == [
        Match(start=2, end=5, k=1)]
    # NUL bytes are legal: padding is masked by length, not zero filled
    assert th.hamming_search_simd_with_opts(
        b"a\0c", b"xxa\0cxx", 0, SearchType.All, **CPU) == [
            Match(start=2, end=5, k=0)]
    # as the JAX package: an empty needle finds nothing on the device path
    assert th.hamming_search_simd_with_opts(b"", b"abc", 1, **CPU) == \
        jh.hamming_search_simd_with_opts(b"", b"abc", 1) == []
    # nothing within k
    assert th.hamming_search_simd_with_opts(b"zzz", b"abcabc", 1, **CPU) == []
    assert th.hamming_search_simd_with_opts(
        b"zzz", b"abcabc", 1, SearchType.All, **CPU) == []


@pytest.mark.parametrize("st_name", ["Best", "All"])
@pytest.mark.parametrize("case", ["sparse", "dense", "k_above_needle"])
def test_hamming_search_equals_jax_and_oracle(case, st_name):
    st, jst = SearchType[st_name], JSearchType[st_name]
    if case == "sparse":  # one planted region in random noise
        rng = np.random.default_rng(55)
        hay = rng.integers(0, 250, 20_000).astype(np.uint8)
        needle = np.full(24, 251, dtype=np.uint8)
        mut = needle.copy()
        mut[5] = 0
        hay[9_000:9_024] = mut
        k = 3
    elif case == "dense":  # low-complexity text, the blessed default k
        rng = np.random.default_rng(91)
        hay = rng.integers(65, 67, 6_000).astype(np.uint8)
        needle = rng.integers(65, 67, 16).astype(np.uint8)
        hay[2_000:2_016] = needle
        k = 8
    else:  # every position is a hit in All mode
        rng = np.random.default_rng(4)
        hay = rng.integers(65, 70, 700).astype(np.uint8)
        needle = rng.integers(65, 70, 5).astype(np.uint8)
        k = 9
    got = th.hamming_search_simd_with_opts(needle, hay, k, st, **CPU)
    assert last_dispatch().path == "torch"
    exp = th.hamming_search_naive_with_opts(needle, hay, k, st)
    ref = jh.hamming_search_simd_with_opts(needle, hay, k, jst)
    assert got == exp and _tuples(got) == _tuples(ref) and got
    if case == "sparse":
        assert Match(start=9_000, end=9_024, k=1) in got


def test_hamming_batch_equals_jax():
    a = np.array([[1, 2, 3, 0], [5, 5, 5, 5]], dtype=np.uint8)
    b = np.array([[1, 9, 3, 0], [5, 5, 0, 0]], dtype=np.uint8)
    lengths = np.array([4, 2])
    assert th.hamming_batch(a, b, lengths, **CPU).tolist() == [1, 0]
    assert th.hamming_batch(a, b, **CPU).tolist() == [1, 2]
    rng = np.random.default_rng(6)
    a = rng.integers(0, 5, (37, 45)).astype(np.uint8)
    b = rng.integers(0, 5, (37, 45)).astype(np.uint8)
    lengths = rng.integers(0, 46, 37)
    got = th.hamming_batch(a, b, lengths, **CPU)
    assert got.dtype == np.int32
    assert got.tolist() == np.asarray(jh.hamming_batch(a, b, lengths)).tolist()
    assert got.tolist() == [int((a[p, :ln] != b[p, :ln]).sum())
                            for p, ln in enumerate(lengths)]
    assert tt.hamming_batch(a, b, **CPU).tolist() == (a != b).sum(1).tolist()
    with pytest.raises(ValueError, match="same shape"):
        th.hamming_batch(a, b[:, :-1], **CPU)


def test_device_functions_on_tensors():
    needle = torch.tensor([1, 2, 3], dtype=torch.uint8)
    hay = torch.tensor([0, 1, 2, 3, 1, 2, 0, 3], dtype=torch.uint8)
    counts = tho.hamming_search_counts(needle, hay)
    assert counts.dtype == torch.int32
    assert counts.tolist() == [3, 0, 3, 3, 1, 2]
    pos, cnt = tho.collect_hamming_hits(counts, 1, best=False)
    assert pos.tolist() == [1, 4] and cnt.tolist() == [0, 1]
    pos, cnt = tho.collect_hamming_hits(counts, 1, best=True)
    assert pos.tolist() == [1] and cnt.tolist() == [0]
    assert tho.collect_hamming_hits(counts + 2, 1, best=True)[0].size == 0
    assert tho.collect_hamming_hits(counts[:0], 1, best=False)[0].size == 0


def test_forced_oracle_path(monkeypatch):
    monkeypatch.setenv("TRIPLE_ACCEL_TORCH_FORCE_PATH", "oracle")
    assert th.hamming(b"abc", b"abd", **CPU) == 1
    assert th.hamming_search_simd_with_opts(
        b"abc", b"  abd", 1, SearchType.All, **CPU) == [
            Match(start=2, end=5, k=1)]


def _cpu_mesh(D):
    from triple_accel_tpu_torch.parallel import make_mesh

    return make_mesh(["cpu"] * D)


def _search_sharded():
    rng = np.random.default_rng(61)
    needle = rng.integers(65, 68, 6).astype(np.uint8)
    hay = rng.integers(65, 68, 300).astype(np.uint8)
    hay[97:103] = needle  # straddles the shard edge at 100
    for st in (SearchType.Best, SearchType.All):
        got = th.hamming_search_sharded(needle, hay, 2, _cpu_mesh(3), st,
                                        **CPU)
        assert got == th.hamming_search_simd_with_opts(needle, hay, 2, st,
                                                       **CPU)
        assert _tuples(got) == _tuples(jh.hamming_search_simd_with_opts(
            needle, hay, 2, JSearchType[st.name]))


def _top_level_search_sharded():
    # a needle longer than a shard, and shards without a start position
    needle, hay = b"abcab", b"xxabcabyyabcab"
    got = tt.hamming_search_sharded(needle, hay, 1, _cpu_mesh(5),
                                    SearchType.All, **CPU)
    assert got == [Match(start=2, end=7, k=0), Match(start=9, end=14, k=0)]


def _batch_mesh():
    rng = np.random.default_rng(62)
    a = rng.integers(0, 3, (11, 9)).astype(np.uint8)
    b = rng.integers(0, 3, (11, 9)).astype(np.uint8)
    lengths = rng.integers(0, 10, 11)
    for D in (1, 4, 13):  # 13 devices: two blocks empty
        got = th.hamming_batch(a, b, lengths, mesh=_cpu_mesh(D), **CPU)
        assert np.array_equal(got, th.hamming_batch(a, b, lengths, **CPU))
    assert last_dispatch().path == "torch"


@pytest.mark.parametrize("call", [
    _search_sharded, _top_level_search_sharded, _batch_mesh,
], ids=["search_sharded", "top_level_search_sharded", "batch_mesh"])
def test_unported_hamming_routes_raise(call):
    """The routes that raised NotImplementedError until the mesh layer was
    ported: each equals its meshless call on a CPU mesh."""
    call()


@pytest.mark.parametrize("call", [
    lambda: tt.hamming(b"abc", b"abd"),
    lambda: tt.hamming_batch(np.zeros((1, 2), np.uint8),
                             np.zeros((1, 2), np.uint8)),
    lambda: tt.hamming_search(b"abc", b"xxabcxx"),
], ids=["hamming", "hamming_batch", "hamming_search"])
def test_default_device_raises_without_a_card(call):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="cuda"):
        call()
