"""Public Hamming distance and Hamming search API of the port.

Counterpart of the JAX package's `hamming.py`, which mirrors the reference's
`triple_accel::hamming` module (src/hamming.rs): the blessed functions
`hamming` / `hamming_search` plus every named variant, with identical
result semantics.  The device half is plain PyTorch ops
(ops/hamming_ops.py): the JAX package has no hand-written kernel here
either.

Deviations from the reference that the JAX package made and the port keeps:
the device path supports NUL bytes (padding is masked by length, not zero
filled), and `hamming_batch` is the high-throughput entry point, one
dispatch for a whole [B, L] batch.

Device rule: every entry point takes a keyword-only `device=`; None means
"cuda", and a CUDA device without a card raises (`dispatch.resolve_device`).
`hamming_batch(mesh=)` splits the batch into contiguous blocks, one a
device of a `parallel.Mesh`, and `hamming_search_sharded` splits one
haystack into shards, each with the m - 1 bytes after it.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from .dispatch import DispatchDecision, forced_path, resolve_device
from .oracle.hamming import (
    default_hamming_k,
    hamming_naive,
    hamming_search_naive,
    hamming_search_naive_with_opts,
    hamming_words_64,
    hamming_words_128,
)
from .types import BytesLike, Match, SearchType, to_bytes_array

__all__ = [
    "hamming",
    "hamming_naive",
    "hamming_words_64",
    "hamming_words_128",
    "hamming_simd_parallel",
    "hamming_simd_movemask",
    "hamming_batch",
    "hamming_search",
    "hamming_search_naive",
    "hamming_search_naive_with_opts",
    "hamming_search_simd",
    "hamming_search_sharded",
    "hamming_search_simd_with_opts",
    "default_hamming_k",
]


def _to_device(arr: np.ndarray, dev: torch.device) -> torch.Tensor:
    arr = np.ascontiguousarray(arr)
    if not arr.flags.writeable:  # torch refuses read-only buffers
        arr = arr.copy()
    return torch.from_numpy(arr).to(dev)


def hamming_simd_parallel(a: BytesLike, b: BytesLike, *, device=None) -> int:
    """Device-accelerated mismatch count (reference hamming.rs:317-330).
    The name is kept for API parity; here it is one fused reduction.

    >>> hamming_simd_parallel(b"abc", b"abd", device="cpu")
    1
    """
    dev = resolve_device(device)
    a = to_bytes_array(a)
    b = to_bytes_array(b)
    if len(a) != len(b):
        raise ValueError("strings must have equal lengths for Hamming distance")
    if forced_path() == "oracle" or len(a) == 0:
        return hamming_naive(a, b)
    return int(hamming_batch(a[None, :], b[None, :], np.array([len(a)]),
                             device=dev)[0])


def hamming_simd_movemask(a: BytesLike, b: BytesLike, *, device=None) -> int:
    """API-parity alias (reference hamming.rs:354-367): the movemask trick
    is x86-specific; both variants are the same reduction here."""
    return hamming_simd_parallel(a, b, device=device)


def hamming(a: BytesLike, b: BytesLike, *, device=None) -> int:
    """Hamming distance via the best available path (reference
    hamming.rs:390).

    >>> hamming(b"abc", b"abd", device="cpu")
    1
    """
    return hamming_simd_parallel(a, b, device=device)


def hamming_batch(
    a: np.ndarray, b: np.ndarray, lengths: Optional[np.ndarray] = None,
    mesh=None, *, device=None,
) -> np.ndarray:
    """Batched Hamming distance: one device dispatch for [B, L] pairs.

    `lengths` masks each pair's valid prefix (defaults to the full width).
    Returns int32 [B].  `mesh` (a `parallel.Mesh`) splits the batch into
    contiguous blocks, one a device (`parallel.batch_sharding`), with no
    communication; results equal the meshless call.  `device=`, if given,
    must be the mesh's first device.
    """
    from .ops.hamming_ops import hamming_kernel
    from .parallel.mesh import batch_sharding, mesh_device
    from .parallel.sharded import run_sharded

    dev = resolve_device(device) if mesh is None else mesh_device(mesh,
                                                                  device)
    a = np.ascontiguousarray(a)
    b = np.ascontiguousarray(b)
    if a.shape != b.shape:
        raise ValueError("a and b batches must have the same shape")
    B0 = a.shape[0]
    if lengths is None:
        lengths = np.full(B0, a.shape[1], dtype=np.int32)
    lengths = np.asarray(lengths, dtype=np.int32)
    DispatchDecision(
        path="torch" if mesh is None else "torch_sharded", cost_bucket="u32",
        unit_k=0, max_k=0, padded_m=B0, padded_n=a.shape[1],
    ).log("hamming_batch")

    def launch(block, d):
        lo, hi = block
        return hamming_kernel(_to_device(a[lo:hi], d),
                              _to_device(b[lo:hi], d),
                              _to_device(lengths[lo:hi], d))

    if mesh is None:
        return launch((0, B0), dev).cpu().numpy()
    parts = run_sharded(mesh, launch,
                        [(lo, hi) if hi > lo else None
                         for lo, hi in batch_sharding(mesh, B0)])
    return np.concatenate([np.empty(0, np.int32)]
                          + [p for p in parts if p is not None])


def hamming_search_simd_with_opts(
    needle: BytesLike,
    haystack: BytesLike,
    k: int,
    search_type: SearchType = SearchType.Best,
    *,
    device=None,
) -> List[Match]:
    """Device-accelerated Hamming search (reference hamming.rs:454-475).

    The device computes the mismatch count at every position in parallel
    and picks the hits; the host applies the reference's streaming
    threshold semantics (Best: curr_k shrinks per hit, the final filter
    keeps k == final curr_k; no overlap dedup — unlike Levenshtein
    search).
    """
    from .ops.hamming_ops import hamming_search_counts

    dev = resolve_device(device)
    needle = to_bytes_array(needle)
    haystack = to_bytes_array(haystack)
    if len(needle) > len(haystack) or len(needle) == 0:
        return []
    if forced_path() == "oracle":
        return hamming_search_naive_with_opts(needle, haystack, k, search_type)

    m, n = len(needle), len(haystack)
    DispatchDecision(
        path="torch", cost_bucket="u32", unit_k=0, max_k=k,
        padded_m=m, padded_n=n,
    ).log("hamming_search_simd_with_opts")
    counts_d = hamming_search_counts(_to_device(needle, dev),
                                     _to_device(haystack, dev))
    return _resolve_counts_matches(counts_d, m, n, k, search_type)


def _resolve_counts_matches(counts_d: torch.Tensor, m: int, n: int, k: int,
                            search_type: SearchType) -> List[Match]:
    """Hit fetch + streaming postprocess over the device-resident
    per-position counts (start position p at counts_d[p]).

    Streaming Best keeps exactly the candidates at the final curr_k, which
    is the global minimum count (no overlap dedup in hamming search), so
    only those positions are fetched; All keeps every position with count
    <= k.  Positions come back ascending, which is stream order."""
    from .ops.hamming_ops import collect_hamming_hits

    pos, cnt = collect_hamming_hits(
        counts_d[: n - m + 1], min(k, m), search_type == SearchType.Best)
    return [Match(start=p, end=p + m, k=c)
            for p, c in zip(pos.tolist(), cnt.tolist())]


def hamming_search_simd(needle: BytesLike, haystack: BytesLike, *,
                        device=None) -> List[Match]:
    """Default device search: k = ceil(len/2), Best (reference
    hamming.rs:422-424)."""
    needle = to_bytes_array(needle)
    return hamming_search_simd_with_opts(
        needle, haystack, default_hamming_k(len(needle)), SearchType.Best,
        device=device,
    )


def hamming_search(needle: BytesLike, haystack: BytesLike, *,
                   device=None) -> List[Match]:
    """Blessed search entry point (reference hamming.rs:588-590).

    >>> hamming_search(b"abc", b"  abd", device="cpu") == [
    ...     Match(start=2, end=5, k=1)]
    True
    """
    return hamming_search_simd(needle, haystack, device=device)


def hamming_search_sharded(
    needle: BytesLike,
    haystack: BytesLike,
    k: int,
    mesh=None,
    search_type: SearchType = SearchType.Best,
    *,
    device=None,
) -> List[Match]:
    """Hamming search of ONE haystack sharded across a mesh (the JAX
    package's `hamming_search_sharded`): exactly
    `hamming_search_simd_with_opts`'s result.  `mesh=None` takes every
    visible card (`parallel.make_mesh()`).

    The haystack splits into D shards of ceil(n / D) bytes; device d gets
    [shard d | the m - 1 bytes after it] (`parallel.right_halo_windows`,
    copied device to device from as many right neighbours as it spans)
    and counts mismatches at the start positions of its own shard, so
    start positions partition exactly and no hit needs an owner rule.
    Best keeps the positions at the minimum over every shard.  `device=`,
    if given, must be the mesh's first device.
    """
    from .ops.hamming_ops import collect_hamming_hits, hamming_search_counts
    from .parallel.mesh import make_mesh, mesh_device
    from .parallel.sharded import (
        right_halo_windows,
        run_sharded,
        shard_bounds,
        upload_shards,
    )

    if mesh is None:
        mesh = make_mesh()
    mesh_device(mesh, device)
    needle = to_bytes_array(needle)
    haystack = to_bytes_array(haystack)
    m, n = len(needle), len(haystack)
    if m > n or m == 0:
        return []
    if forced_path() == "oracle":
        return hamming_search_naive_with_opts(needle, haystack, k,
                                              search_type)
    bounds = shard_bounds(n, mesh.size)
    DispatchDecision(
        path="torch_sharded", cost_bucket="u32", unit_k=m - 1, max_k=k,
        padded_m=m, padded_n=bounds[0][1],
    ).log("hamming_search_sharded")
    windows = right_halo_windows(mesh, upload_shards(mesh, haystack, bounds),
                                 m - 1)
    # a window shorter than the needle owns no start position
    blocks = [w if w.shape[0] >= m else None for w in windows]
    counts = run_sharded(
        mesh, lambda w, d: hamming_search_counts(_to_device(needle, d), w),
        blocks, fetch=lambda c: c)
    kk = min(k, m)
    if search_type == SearchType.Best:
        # the streaming threshold ends at the minimum over every shard,
        # and keeps exactly the positions there
        kk = min(int(c.min()) for c in counts if c is not None)
        if kk > min(k, m):
            return []
    hits = run_sharded(
        mesh, lambda c, d: c, counts,
        fetch=lambda c: collect_hamming_hits(c, kk, False))
    out: List[Match] = []
    for (lo, _), h in zip(bounds, hits):
        if h is not None:
            out.extend(Match(start=lo + p, end=lo + p + m, k=c)
                       for p, c in zip(h[0].tolist(), h[1].tolist()))
    return out
