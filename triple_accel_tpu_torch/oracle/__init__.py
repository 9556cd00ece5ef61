"""Pure NumPy/Python scalar oracle: the judge of semantics for the port.

Analog of the reference's `*_naive*` functions (the always-available scalar
fallbacks that its SIMD implementations are differentially tested against).
"""

from .hamming import (
    default_hamming_k,
    hamming_naive,
    hamming_search_naive,
    hamming_search_naive_with_opts,
    hamming_words_64,
    hamming_words_128,
)
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
    "default_hamming_k",
    "hamming_naive",
    "hamming_search_naive",
    "hamming_search_naive_with_opts",
    "hamming_words_64",
    "hamming_words_128",
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
