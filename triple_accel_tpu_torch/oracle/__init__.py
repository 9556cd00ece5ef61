"""Pure NumPy/Python scalar oracle: the judge of semantics for the port.

Analog of the reference's `*_naive*` functions (the always-available scalar
fallbacks that its SIMD implementations are differentially tested against).
Only the Levenshtein half is carried by the port so far.
"""

from .levenshtein import (
    compute_max_k,
    compute_unit_k,
    default_search_k,
    levenshtein_naive,
    levenshtein_naive_k,
    levenshtein_naive_k_with_opts,
    levenshtein_naive_with_opts,
    levenshtein_search_naive,
    levenshtein_search_naive_with_opts,
)

__all__ = [
    "compute_max_k",
    "compute_unit_k",
    "default_search_k",
    "levenshtein_naive",
    "levenshtein_naive_k",
    "levenshtein_naive_k_with_opts",
    "levenshtein_naive_with_opts",
    "levenshtein_search_naive",
    "levenshtein_search_naive_with_opts",
]
