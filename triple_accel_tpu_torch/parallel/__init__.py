"""Multi-device and multi-process scaling of the port: DP pair batches,
SP sharded-haystack search with a halo ring, and the cross-process
assembly of Match lists.

Counterpart of the JAX package's `parallel/`.  A mesh is one process over
a tuple of `torch.device`s (`mesh.py`); `torch.distributed` is used only
across processes (`multihost.py`, `assert_mesh_consistent`).  Names
follow the JAX package where a counterpart exists.
"""

from .mesh import (
    DATA_AXIS,
    Mesh,
    assert_mesh_consistent,
    batch_sharding,
    make_mesh,
)
from .multihost import allgather_matches, decode_matches, encode_matches
from .sharded import (
    HaloWindows,
    collect_owned_hits,
    halo_windows,
    match_count_psum,
    right_halo_windows,
    run_sharded,
    shard_bounds,
)

__all__ = [
    "DATA_AXIS",
    "Mesh",
    "assert_mesh_consistent",
    "batch_sharding",
    "make_mesh",
    "allgather_matches",
    "decode_matches",
    "encode_matches",
    "HaloWindows",
    "collect_owned_hits",
    "halo_windows",
    "match_count_psum",
    "right_halo_windows",
    "run_sharded",
    "shard_bounds",
]
