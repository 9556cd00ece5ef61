"""triple_accel_tpu_torch — the PyTorch/CUDA port of triple_accel_tpu.

Edit distance and approximate string search with the result semantics of
the reference `triple_accel` crate, on an NVIDIA Hopper GPU: plain tensor
code is PyTorch, and every device kernel is hand-written CUDA C++ under
`csrc/`, built with `nvcc` at first use.  The package imports torch, numpy
and the standard library, never JAX and nothing of `triple_accel_tpu`; the
JAX package stays beside it as the reference the tests compare against.

Module names follow the JAX package's so a reader finds the counterpart.
So far the port carries the distance paths (`levenshtein_k_batch` and its
wrappers: unit costs on the Myers kernel, every cost model, wide bands and
tracebacks on the general band kernels), the Myers search path
(`levenshtein_search*`, unit and restricted-Damerau costs) and Hamming
distance and search; every other route raises `NotImplementedError`
naming the JAX engine still to be ported.  Entry points run on "cuda"
unless the caller passes `device=`; without a card they raise.
"""

from .types import (
    Edit,
    EditCosts,
    EditType,
    LEVENSHTEIN_COSTS,
    Match,
    RDAMERAU_COSTS,
    SearchType,
    alloc_str,
    check_no_null_bytes,
    fill_str,
    to_bytes_array,
)

from . import oracle
from . import hamming
from . import levenshtein

from .hamming import (
    hamming_batch,
    hamming_search,
    hamming_search_sharded,
)
from .levenshtein import (
    levenshtein_exp,
    levenshtein_exp_batch,
    levenshtein_k_batch,
    levenshtein_search,
    PackedHaystack,
    levenshtein_search_many,
    levenshtein_search_sharded,
    rdamerau,
    rdamerau_exp,
)

# The reference re-exports `hamming` / `levenshtein` as top-level functions
# (src/lib.rs:126-127).  In Python those names collide with the submodules,
# so the top-level callables get the submodules' blessed functions via
# explicit aliases while the submodules stay importable.
globals()["hamming"] = hamming.hamming
globals()["levenshtein"] = levenshtein.levenshtein

__version__ = "0.1.0"

__all__ = [
    "Match",
    "Edit",
    "EditType",
    "SearchType",
    "EditCosts",
    "LEVENSHTEIN_COSTS",
    "RDAMERAU_COSTS",
    "alloc_str",
    "fill_str",
    "check_no_null_bytes",
    "to_bytes_array",
    "oracle",
    "hamming",
    "hamming_batch",
    "hamming_search_sharded",
    "hamming_search",
    "levenshtein",
    "levenshtein_k_batch",
    "levenshtein_exp",
    "levenshtein_exp_batch",
    "levenshtein_search",
    "PackedHaystack",
    "levenshtein_search_many",
    "levenshtein_search_sharded",
    "rdamerau",
    "rdamerau_exp",
]
