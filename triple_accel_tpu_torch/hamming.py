"""Hamming distance and search: names only, so far.

The JAX package's `hamming.py` is not ported yet; every entry point raises
`NotImplementedError` naming the JAX engine it runs on, so a caller learns
at once that the route is missing instead of getting a host computation.
"""

from __future__ import annotations

__all__ = [
    "hamming",
    "hamming_batch",
    "hamming_search",
    "hamming_search_simd",
    "hamming_search_simd_with_opts",
    "hamming_search_sharded",
]


def _not_ported(name: str, engine: str):
    def stub(*args, **kwargs):
        raise NotImplementedError(
            f"{name} is not ported to triple_accel_tpu_torch yet: the JAX "
            f"package runs it on {engine}"
        )

    stub.__name__ = name
    stub.__doc__ = f"Not ported yet (JAX engine: {engine})."
    return stub


hamming = _not_ported("hamming", "ops/hamming_ops.py hamming_kernel")
hamming_batch = _not_ported("hamming_batch",
                            "ops/hamming_ops.py hamming_kernel")
hamming_search_simd_with_opts = _not_ported(
    "hamming_search_simd_with_opts",
    "ops/hamming_ops.py hamming_search_block_mins")
hamming_search_simd = _not_ported(
    "hamming_search_simd", "ops/hamming_ops.py hamming_search_block_mins")
hamming_search = _not_ported(
    "hamming_search", "ops/hamming_ops.py hamming_search_block_mins")
hamming_search_sharded = _not_ported(
    "hamming_search_sharded",
    "parallel/sharded.py sharded_hamming_search_mins")
