"""Resumable slab-wise search sweeps over very long haystacks.

Own copy, for the PyTorch/CUDA port, of the JAX package's `sweep.py`.
`levenshtein_search_sweep` searches the haystack slab by slab (each slab
one call of `levenshtein_search_simd_with_opts` on the device), saves a
cursor and the compact candidate list after every slab
(utils/checkpoint.py), and applies the global Best / All streaming rules
at the end.  Candidates are matches with cost <= k, and the streaming pass
only ever inspects those, so collecting them slab by slab equals the
reference's one-pass iterator.

Slabs overlap by the match window, and a candidate belongs to the slab
that holds its end, so the result equals one monolithic search.
"""

from __future__ import annotations

import os
from typing import List, Optional

from .dispatch import resolve_device
from .oracle.levenshtein import default_search_k
from .types import (
    BytesLike,
    EditCosts,
    LEVENSHTEIN_COSTS,
    Match,
    SearchType,
    to_bytes_array,
)

__all__ = ["levenshtein_search_sweep"]


def levenshtein_search_sweep(
    needle: BytesLike,
    haystack: BytesLike,
    k: Optional[int] = None,
    search_type: SearchType = SearchType.Best,
    costs: EditCosts = LEVENSHTEIN_COSTS,
    slab_chars: int = 1 << 25,
    checkpoint_path: Optional[str] = None,
    mesh=None,
    *,
    device=None,
) -> List[Match]:
    """Search a very long haystack slab by slab, optionally resumable.

    Equal to `levenshtein_search_simd_with_opts(needle, haystack, k,
    search_type, costs, False)` (k None: the default `ceil(m / 2)`), but
    each slab's device memory is bounded by `slab_chars`, and with
    `checkpoint_path` a killed sweep resumes from the last finished slab
    (the checkpoint is deleted on success).  In Best mode the running
    minimum cost shrinks the later slabs' threshold and is saved with the
    cursor.  `mesh=` (a `parallel.Mesh`) runs every slab through
    `levenshtein_search_sharded` on the mesh; the checkpoint's keys and
    the streaming rules do not change, so a sweep resumes on another mesh
    size, or on none.  `device=`, if given, must be the mesh's first
    device.
    """
    from .levenshtein import (
        levenshtein_search_sharded,
        levenshtein_search_simd_with_opts,
    )
    from .ops.search_common import window_span
    from .parallel.mesh import mesh_device
    from .utils.checkpoint import SweepCheckpoint

    dev = resolve_device(device) if mesh is None else mesh_device(mesh,
                                                                  device)
    needle = to_bytes_array(needle)
    haystack = to_bytes_array(haystack)
    m, n = len(needle), len(haystack)
    if k is None:
        k = default_search_k(m)

    def _search(hay, kk, st):
        if mesh is not None:
            return levenshtein_search_sharded(needle, hay, kk, mesh, st,
                                              costs)
        return levenshtein_search_simd_with_opts(needle, hay, kk, st, costs,
                                                 False, device=dev)

    if m == 0 or n <= slab_chars:
        return _search(haystack, k, search_type)
    costs.check_search()

    halo = min(window_span(m, k, costs.gap_cost, costs.start_gap_cost), n)
    ckpt = (SweepCheckpoint.load_or_create(checkpoint_path)
            if checkpoint_path else SweepCheckpoint(path=""))

    # candidates (global coordinates, cost <= the threshold) accumulate in
    # ckpt.matches; in Best mode the running minimum curr_k shrinks as
    # slabs stream and later candidates above it are dropped at once: the
    # final streaming pass would never emit them, and the checkpoint stays
    # small on hit-dense haystacks
    offset = ckpt.offset
    curr_k = ckpt.curr_k if ckpt.curr_k is not None else k
    while offset < n:
        slab_end = min(offset + slab_chars, n)
        lo = max(0, offset - halo)
        new = []
        for c in _search(haystack[lo:slab_end], curr_k, SearchType.All):
            g_end = lo + c.end
            # owner by end: only candidates ending inside this slab's
            # owned range; the empty-prefix candidate belongs to slab 0
            if (offset < g_end <= slab_end) or (g_end == 0 and offset == 0):
                if search_type == SearchType.Best:
                    if c.k > curr_k:
                        continue
                    curr_k = c.k
                new.append(Match(start=lo + c.start, end=g_end, k=c.k))
        if checkpoint_path:
            ckpt.advance(slab_end, new, curr_k=curr_k)
        else:
            ckpt.matches.extend(new)
            ckpt.offset = slab_end
        offset = slab_end

    cands = ckpt.matches
    if checkpoint_path and os.path.exists(checkpoint_path):
        os.unlink(checkpoint_path)
    if search_type == SearchType.All:
        return list(cands)

    # the global Best streaming pass over the compact candidates
    res: List[Match] = []
    curr_k = k
    for c in cands:
        if c.k <= curr_k:
            curr_k = c.k
            if res and c.start <= res[-1].start:
                res[-1] = c
            else:
                res.append(c)
    return [c for c in res if c.k == curr_k]
