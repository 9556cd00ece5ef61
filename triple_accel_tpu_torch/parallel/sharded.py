"""Multi-device execution: DP pair batches and SP sharded-haystack search.

Counterpart of the JAX package's `parallel/sharded.py`; only its semantics
are ported.  A mesh (`mesh.py`) is one process over a tuple of devices, so
the JAX `shard_map` bodies become a loop that issues every shard's launch
on its own device (under `torch.cuda.device`) before the first result is
fetched, and shards on distinct cards run side by side:

* `run_sharded`: DP.  Each block runs on its device with zero
  collectives; the results come back after every launch is issued.
* `halo_windows`: the ring of SP search.  Device d gets [left halo | own
  shard], the halo copied from as many left neighbours as it spans (the
  JAX `lax.ppermute` ring is a device-to-device copy,
  `tail.to(mesh.devices[d], non_blocking=True)`).  A halo longer than a
  shard is exact; the JAX scan path raises there.  Device 0 gets no halo:
  the kernels start a window's first segment at its byte 0 with a fresh
  state, so there is no synthetic pad and nothing to correct.
* `right_halo_windows`: Hamming's ring, the m - 1 bytes after each shard,
  so start positions partition exactly.
* `collect_owned_hits`: the owner-by-end rule (the JAX
  `collect_sharded_hits` and `assemble_sharded_search`).  Device d keeps
  the end positions of its own shard, [halo_eff, halo_eff + len(shard)]
  local to its window (excluding halo_eff for d > 0: that end is its left
  neighbour's last), shifted by d * S - halo_eff.
* `match_count_psum`: the global count of distances <= k, a sum of
  per-device counts.
* `HaloWindows`: the windows of one haystack, resident on the mesh
  (`PackedHaystack.pack_sharded`).

JAX functions with no counterpart on purpose: they are TPU layouts, and
the port's kernels take the raw haystack and the batch as they are.
`pad_batch_for_mesh` and `_check_lane_split` (128-lane blocks and at
least 2 grid steps a device); `_left_halo_windows` / `device_windows` and
`device_grouped_transpose` (segment windows materialised for the TPU
kernels: the port's kernels read a shard's window in place); the
`sharded_*` wrappers around each Pallas kernel (the entry points run each
engine's own wrapper per shard); `sharded_pack_segs` (the resident pack is
the windows themselves); and every `interpret` switch (a CPU mesh runs
the plain versions).
"""

from __future__ import annotations

from contextlib import nullcontext
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .mesh import Mesh

__all__ = [
    "on_device",
    "run_sharded",
    "shard_bounds",
    "upload_shards",
    "halo_windows",
    "right_halo_windows",
    "collect_owned_hits",
    "match_count_psum",
    "HaloWindows",
]

# a window view starts on this byte boundary (the kernels read 16-byte
# chunks from 32-byte sectors): a larger halo than asked is still exact
_VIEW_ALIGN = 32


def on_device(dev: torch.device):
    """The context a shard's launches run in: `torch.cuda.device(dev)` on
    a card, nothing on the CPU."""
    return torch.cuda.device(dev) if dev.type == "cuda" else nullcontext()


def _to_host(out):
    """Device tensors (or tuples of them) to numpy on the host."""
    if isinstance(out, torch.Tensor):
        return out.cpu().numpy()
    if isinstance(out, (tuple, list)):
        return type(out)(_to_host(o) for o in out)
    return out


def run_sharded(mesh: Mesh, fn: Callable, blocks: Sequence,
                fetch: Callable = _to_host) -> list:
    """`fetch(fn(blocks[d], mesh.devices[d]))` for every device d, with
    every `fn` issued (on its device) before the first `fetch`, so shards
    on distinct cards overlap.  A block that is None is skipped and gives
    None."""
    if len(blocks) != mesh.size:
        raise ValueError(f"{len(blocks)} blocks for a mesh of {mesh.size}")
    outs = []
    for dev, blk in zip(mesh.devices, blocks):
        if blk is None:
            outs.append(None)
            continue
        with on_device(dev):
            outs.append(fn(blk, dev))
    res = []
    for dev, out in zip(mesh.devices, outs):
        if out is None:
            res.append(None)
            continue
        with on_device(dev):
            res.append(fetch(out))
    return res


def shard_bounds(n: int, D: int) -> List[Tuple[int, int]]:
    """[lo, hi) bytes of each of D haystack shards of ceil(n / D) bytes
    (the last ones shorter, or empty when n < D)."""
    S = -(-int(n) // D) if n else 0
    return [(min(d * S, n), min((d + 1) * S, n)) for d in range(D)]


def upload_shards(mesh: Mesh, haystack: np.ndarray,
                  bounds: Sequence[Tuple[int, int]]) -> List[torch.Tensor]:
    """Shard d of the host haystack on mesh.devices[d] (one upload a
    device)."""
    hay = np.ascontiguousarray(haystack, dtype=np.uint8)
    out = []
    for dev, (lo, hi) in zip(mesh.devices, bounds):
        part = hay[lo:hi]
        if not part.flags.writeable:  # torch refuses read-only buffers
            part = part.copy()
        with on_device(dev):
            out.append(torch.from_numpy(part).to(dev))
    return out


def halo_windows(mesh: Mesh, hay_shards: Sequence[torch.Tensor],
                 halo: int) -> List[torch.Tensor]:
    """Window d = [the `halo` bytes before shard d | shard d] on
    mesh.devices[d], the halo copied device to device from as many left
    neighbours as it spans (fewer bytes where the haystack starts).
    Every window is a fresh allocation or the uploaded shard itself, so
    16-byte aligned."""
    out = []
    for d, dev in enumerate(mesh.devices):
        pieces, need = [hay_shards[d]], halo
        for e in range(d - 1, -1, -1):
            if need <= 0:
                break
            src = hay_shards[e]
            take = min(need, src.shape[0])
            if take:
                pieces.insert(0, src[src.shape[0] - take:].to(
                    dev, non_blocking=True))
            need -= take
        with on_device(dev):
            # a lone shard is its own window: the upload is aligned
            out.append(pieces[0] if len(pieces) == 1 else torch.cat(pieces))
    return out


def right_halo_windows(mesh: Mesh, hay_shards: Sequence[torch.Tensor],
                       halo: int) -> List[torch.Tensor]:
    """Window d = [shard d | the `halo` bytes after it] on
    mesh.devices[d], copied from as many right neighbours as it spans
    (fewer where the haystack ends)."""
    out = []
    for d, dev in enumerate(mesh.devices):
        pieces, need = [hay_shards[d]], halo
        for e in range(d + 1, mesh.size):
            if need <= 0:
                break
            src = hay_shards[e]
            take = min(need, src.shape[0])
            if take:
                pieces.append(src[:take].to(dev, non_blocking=True))
            need -= take
        with on_device(dev):
            out.append(torch.cat(pieces))
    return out


def collect_owned_hits(shard_hits: Sequence[Optional[tuple]],
                       halo_eff: Sequence[int],
                       bounds: Sequence[Tuple[int, int]]) -> tuple:
    """The owner-by-end rule over per-shard hits.

    `shard_hits[d]` is (end positions local to shard d's window, *columns)
    as numpy arrays, or None for a shard that ran nothing; `halo_eff[d]`
    the bytes of left halo its window holds before the shard's first byte;
    `bounds[d]` the shard's global [lo, hi).  Shard 0 keeps local ends
    [0, hi - lo], shard d > 0 the ends (halo_eff, halo_eff + hi - lo] (its
    first end is its left neighbour's last).  Returns (global ends,
    *columns), concatenated in shard order: sorted by end when each
    shard's are."""
    kept = []
    width = None
    for d, hits in enumerate(shard_hits):
        if hits is None:
            continue
        width = len(hits)
        pos = np.asarray(hits[0], dtype=np.int64)
        lo, hi = bounds[d]
        h = int(halo_eff[d])
        first = h if d == 0 else h + 1
        keep = (pos >= first) & (pos <= h + hi - lo)
        kept.append((pos[keep] - h + lo,
                     *(np.asarray(c)[keep] for c in hits[1:])))
    if not kept:
        z = np.empty(0, dtype=np.int64)
        return tuple(z.copy() for _ in range(width or 1))
    if len(kept) == 1:
        return kept[0]
    return tuple(np.concatenate([k[i] for k in kept])
                 for i in range(width))


def match_count_psum(mesh: Mesh, dists, k: int) -> int:
    """Global count of distances <= k: per-device counts summed (the JAX
    `lax.psum`).  `dists` is one tensor or array per device, or one array
    that is split by `batch_sharding` and placed on the mesh first."""
    from .mesh import batch_sharding

    if isinstance(dists, (np.ndarray, torch.Tensor)):
        arr = torch.as_tensor(dists)
        dists = [arr[lo:hi] for lo, hi in batch_sharding(mesh, len(arr))]
    counts = run_sharded(
        mesh, lambda t, dev: (torch.as_tensor(t).to(dev) <= k).sum(),
        list(dists), fetch=lambda c: int(c.item()))
    return int(sum(counts))


class HaloWindows:
    """One haystack sharded on a mesh: shard d (ceil(n / D) bytes) with
    up to `halo` bytes of its left neighbours before it, resident on
    mesh.devices[d].  Built with one upload a device and the ring of
    `halo_windows`; `view(d, h)` serves any halo h <= `halo`.

    `resident(hay_d)` is the meshless search as the D = 1 case: one
    window, a haystack already on its device, not copied.  `sharded`
    tells the two apart (the dispatch log names a mesh's engines with
    `_sharded` appended)."""

    def __init__(self, mesh: Mesh, haystack: np.ndarray, halo: int):
        self.mesh = mesh
        self.n = len(haystack)
        self.halo = int(halo)
        self.bounds = shard_bounds(self.n, mesh.size)
        shards = upload_shards(mesh, haystack, self.bounds)
        self.windows = halo_windows(mesh, shards, self.halo)
        self.halo_eff = [min(self.halo, lo) for lo, _ in self.bounds]
        self.sharded = True

    @classmethod
    def resident(cls, hay_d: torch.Tensor) -> "HaloWindows":
        """`hay_d`, on its device, as the one window of a one-device
        mesh: no halo is needed, since its only shard starts at byte 0."""
        self = cls.__new__(cls)
        self.mesh = Mesh((hay_d.device,))
        self.n = hay_d.shape[0]
        self.halo = 0
        self.bounds = [(0, self.n)]
        self.windows = [hay_d]
        self.halo_eff = [0]
        self.sharded = False
        return self

    def view(self, d: int, halo: int) -> Tuple[torch.Tensor, int]:
        """(window d cut to at least `halo` bytes of left halo, the halo
        bytes it holds).  The cut starts on a 32-byte boundary of the
        window, so the view keeps the window's alignment."""
        if d and halo > self.halo:  # shard 0 starts at byte 0: no halo
            raise ValueError(f"a halo of {halo} bytes from windows of "
                             f"{self.halo}")
        full = self.halo_eff[d]
        start = (full - min(halo, full)) // _VIEW_ALIGN * _VIEW_ALIGN
        return self.windows[d][start:], full - start

    def owned_bytes(self, d: int) -> int:
        lo, hi = self.bounds[d]
        return hi - lo
