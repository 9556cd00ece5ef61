"""Checkpoint / resume for long search sweeps (`sweep.py`).

Own copy, for the PyTorch/CUDA port, of the JAX package's
`utils/checkpoint.py`: a sweep over haystack slabs persists (the next
slab's offset, the candidates found so far, Best's running threshold) so
a preempted job resumes instead of restarting.  Plain `.npz` with the same
keys (`offset`, `start`, `end`, `k`, `curr_k`), so a checkpoint written by
either package resumes in the other.  Numpy only.
"""

from __future__ import annotations

import os
import tempfile
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from ..types import Match

__all__ = ["SweepCheckpoint"]


@dataclass
class SweepCheckpoint:
    """Resumable cursor for a slab-wise haystack sweep.

    `offset` is the first haystack position not yet fully processed;
    `matches` are the candidates accumulated so far; `curr_k` is Best
    mode's running minimum cost (None: not started, stored as -1).
    """

    path: str
    offset: int = 0
    matches: List[Match] = field(default_factory=list)
    curr_k: Optional[int] = None

    @classmethod
    def load_or_create(cls, path: str) -> "SweepCheckpoint":
        if os.path.exists(path):
            with np.load(path) as data:
                ms = [
                    Match(start=int(s), end=int(e), k=int(kk))
                    for s, e, kk in zip(data["start"], data["end"],
                                        data["k"])
                ]
                ck = int(data["curr_k"][0])
                return cls(path=path, offset=int(data["offset"][0]),
                           matches=ms, curr_k=ck if ck >= 0 else None)
        return cls(path=path)

    def save(self) -> None:
        """Atomic write (a temporary file in the same directory, then a
        rename), so a crash never leaves a torn checkpoint."""
        d = os.path.dirname(os.path.abspath(self.path)) or "."
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz.tmp")
        os.close(fd)
        np.savez(
            tmp,
            offset=np.array([self.offset], dtype=np.int64),
            start=np.array([m.start for m in self.matches], dtype=np.int64),
            end=np.array([m.end for m in self.matches], dtype=np.int64),
            k=np.array([m.k for m in self.matches], dtype=np.int64),
            curr_k=np.array(
                [self.curr_k if self.curr_k is not None else -1],
                dtype=np.int64,
            ),
        )
        # np.savez appends .npz to the name it is given
        os.replace(tmp + ".npz", self.path)
        if os.path.exists(tmp):
            os.unlink(tmp)

    def advance(self, new_offset: int, new_matches: List[Match],
                curr_k: Optional[int] = None) -> None:
        """Record a finished slab and save."""
        self.offset = new_offset
        self.matches.extend(new_matches)
        if curr_k is not None:
            self.curr_k = curr_k
        self.save()
