"""Device functions for Hamming distance and Hamming search, in plain
PyTorch ops.

Counterpart of the JAX package's ops/hamming_ops.py, which is plain XLA
code with no hand-written kernel behind it; so these are tensor ops too,
and they run wherever their tensors lie.

* `hamming_kernel`: one fused compare-and-sum over a [B, L] batch, only
  the first `length` positions of a pair counting.
* `hamming_search_counts`: the mismatch count of the needle at every start
  position, a shift-and-accumulate over the needle's offsets; padding is
  masked by position, not zero filled, so NUL bytes are legal input.
* `collect_hamming_hits`: the hits (count <= k, or the positions at the
  global minimum) picked on the device with `torch.nonzero`, so only hits
  reach the host.  The JAX package fetches per-block minima and then the
  candidate blocks instead, because a compaction is slow on its device;
  that two-phase fetch has no counterpart here.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

__all__ = [
    "hamming_kernel",
    "hamming_search_counts",
    "collect_hamming_hits",
]


def hamming_kernel(a: torch.Tensor, b: torch.Tensor,
                   length: torch.Tensor) -> torch.Tensor:
    """Batched mismatch count.  a, b: [B, L] integer chars (pads need not
    agree: only the first `length` positions count).  Returns int32 [B]."""
    idx = torch.arange(a.shape[1], dtype=torch.int32, device=a.device)
    mism = (a != b) & (idx[None, :] < length.to(torch.int32)[:, None])
    return mism.sum(dim=1, dtype=torch.int32)


def hamming_search_counts(needle: torch.Tensor,
                          haystack: torch.Tensor) -> torch.Tensor:
    """Mismatch counts of `needle` [m] at every start position of
    `haystack` [n], m <= n: int32 [n - m + 1]."""
    m, n = needle.shape[0], haystack.shape[0]
    n_pos = n - m + 1
    counts = torch.zeros(n_pos, dtype=torch.int32, device=haystack.device)
    for j in range(m):
        counts += haystack[j:j + n_pos] != needle[j]
    return counts


def collect_hamming_hits(counts: torch.Tensor, k: int,
                         best: bool) -> Tuple[np.ndarray, np.ndarray]:
    """(positions int64, counts int64) of the hits, ascending, on the host.
    All mode: every position with count <= k.  Best mode: the positions at
    the global minimum count if that is <= k (the streaming threshold of
    the reference ends there and keeps exactly those), else nothing."""
    if counts.numel() == 0:
        return np.empty(0, np.int64), np.empty(0, np.int64)
    if best:
        gmin = int(counts.min())
        if gmin > k:
            return np.empty(0, np.int64), np.empty(0, np.int64)
        pos = torch.nonzero(counts == gmin).reshape(-1).cpu().numpy()
        return pos.astype(np.int64), np.full(pos.size, gmin, np.int64)
    pos_d = torch.nonzero(counts <= k).reshape(-1)
    return (pos_d.cpu().numpy().astype(np.int64),
            counts[pos_d].cpu().numpy().astype(np.int64))
