"""Multi-process assembly of Match lists.

Counterpart of the JAX package's `parallel/multihost.py`.  In a job of
several processes each one searches only the haystack shards it owns; the
global Match list is assembled by an all-gather across the processes of
`torch.distributed` (the JAX package's `process_allgather`).  Matches are
encoded as [n, 3] int64 (start, end, k), zero-padded to the largest count
(an all-gather needs equal shapes), gathered, then trimmed and
concatenated in rank order, which keeps the global end-position order as
long as ranks own the haystack in order (the owner-by-end rule,
`sharded.py`).

Without `torch.distributed` initialised, or with a world size of 1, the
gather is the identity.  The tensors go on the CPU for gloo and on the
rank's current CUDA device for NCCL.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from ..types import Match

__all__ = ["allgather_matches", "encode_matches", "decode_matches"]


def _world() -> int:
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return 1
    return dist.get_world_size()


def _all_gather_int64(t: torch.Tensor) -> torch.Tensor:
    """[world, *t.shape] int64 on the CPU: every rank's `t`, in rank
    order."""
    import torch.distributed as dist

    dev = torch.device("cpu")
    if dist.get_backend() == "nccl":
        dev = torch.device("cuda", torch.cuda.current_device())
    t = t.to(device=dev, dtype=torch.int64).contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, t)
    return torch.stack(parts).cpu()


def encode_matches(matches: Sequence[Match]) -> np.ndarray:
    """Matches -> [n, 3] int64 (start, end, k)."""
    out = np.empty((len(matches), 3), dtype=np.int64)
    for i, m in enumerate(matches):
        out[i, 0], out[i, 1], out[i, 2] = m.start, m.end, m.k
    return out


def decode_matches(arr: np.ndarray) -> List[Match]:
    """[n, 3] int64 -> Matches."""
    return [Match(start=int(s), end=int(e), k=int(kk)) for s, e, kk in arr]


def allgather_matches(local_matches: Sequence[Match]) -> List[Match]:
    """The global Match list across all processes of the job.

    Every rank passes the matches of the haystack shards it owns (in
    end-position order); every rank returns the same list, ordered by
    rank.  One process: the identity."""
    if _world() <= 1:
        return list(local_matches)
    local = encode_matches(local_matches)
    counts = _all_gather_int64(
        torch.tensor([local.shape[0]], dtype=torch.int64)).reshape(-1)
    cap = int(counts.max())
    if cap == 0:
        return []
    padded = np.zeros((cap, 3), dtype=np.int64)
    padded[: local.shape[0]] = local
    gathered = _all_gather_int64(torch.from_numpy(padded)).numpy()
    out: List[Match] = []
    for r in range(gathered.shape[0]):
        out.extend(decode_matches(gathered[r, : int(counts[r])]))
    return out
