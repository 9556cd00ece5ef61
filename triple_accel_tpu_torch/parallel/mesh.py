"""Meshes of the port: one process over a tuple of devices.

Counterpart of the JAX package's `parallel/mesh.py`.  A JAX `Mesh` under
`shard_map` is one controller driving its devices; so is a `Mesh` here:
a frozen tuple of `torch.device`s that one process launches on, one shard
a device.  It is not a `torch.distributed` group (only `multihost.py`
and `assert_mesh_consistent` speak across processes).

Entries may repeat: `make_mesh(["cuda:0"] * 4)` is four shards on one
card, as the JAX tests run on 8 virtual CPU devices.  Device rules, the
same as every entry point's `device=`:

* `make_mesh()` takes every visible CUDA device and raises without a card
  (`dispatch.resolve_device`);
* a CPU mesh must be asked for (`make_mesh(["cpu"] * 4)`), and on it each
  shard runs the kernels' plain versions;
* a mesh that mixes CPU and CUDA entries raises `ValueError`.

DP (data parallel: pair batches split into contiguous blocks,
`batch_sharding`) and SP (one haystack split into shards with a halo
ring, `sharded.py`) both map onto this 1-D mesh.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch

from ..dispatch import resolve_device

__all__ = ["DATA_AXIS", "Mesh", "make_mesh", "batch_sharding",
           "assert_mesh_consistent", "mesh_device", "canonical_device"]

DATA_AXIS = "data"


def canonical_device(dev: torch.device) -> torch.device:
    """`dev` with its CUDA index filled in, so "cuda" and "cuda:0" compare
    equal on a one-card machine."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu") if dev.type == "cpu" else dev


@dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: `devices[d]` holds shard d.  `size` is the shard count
    (the JAX `mesh.devices.size`)."""

    devices: Tuple[torch.device, ...]
    axis_name: str = DATA_AXIS

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(devices: Optional[Sequence] = None,
              axis_name: str = DATA_AXIS) -> Mesh:
    """A 1-D mesh over the given devices, or over every visible CUDA
    device (`torch.cuda.device_count()`) when `devices` is None.  Raises
    `RuntimeError` without a card unless CPU devices are given, and
    `ValueError` for an empty mesh or one that mixes CPU and CUDA."""
    if devices is None:
        resolve_device(None)  # raises without a card
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    types = {torch.device(d).type for d in devices}
    if not types:
        raise ValueError("a mesh needs at least one device")
    if len(types) > 1:
        raise ValueError(
            f"a mesh mixes device types {sorted(types)}: every shard runs "
            "on the card or every shard on the CPU")
    return Mesh(tuple(canonical_device(resolve_device(d)) for d in devices),
                axis_name)


def mesh_device(mesh: Mesh, device=None) -> torch.device:
    """The device a mesh call's host-side work and single-device parts
    run on: the mesh's first device.  A `device=` argument naming another
    raises `ValueError`."""
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a parallel.Mesh, not "
                        f"{type(mesh).__name__}")
    first = mesh.devices[0]
    if (device is not None
            and canonical_device(resolve_device(device)) != first):
        raise ValueError(
            f"device={device} is not the mesh's first device {first}")
    return first


def batch_sharding(mesh: Mesh, n: int) -> List[Tuple[int, int]]:
    """The [lo, hi) rows of an n-row batch each device owns: contiguous
    blocks in device order, as even as they come (the first n % D devices
    take one row more).  The counterpart of the JAX `NamedSharding` over
    the batch axis."""
    D = mesh.size
    base, extra = divmod(int(n), D)
    out, lo = [], 0
    for d in range(D):
        hi = lo + base + (1 if d < extra else 0)
        out.append((lo, hi))
        lo = hi
    return out


_TYPE_CODE = {"cpu": 0, "cuda": 1}


def assert_mesh_consistent(mesh: Mesh) -> None:
    """Fail fast when the processes of a job disagree on the mesh: every
    process must see the same mesh size and device type before any
    cross-process gather runs, or the gather deadlocks or mis-assembles.
    A no-op unless `torch.distributed` is initialised with a world size
    above 1; then each rank's (rank, size, device type) signature and a
    sha256 of the axis name are all-gathered and compared."""
    from .multihost import _all_gather_int64, _world

    if _world() <= 1:
        return
    import torch.distributed as dist

    sig = torch.tensor([dist.get_rank(), mesh.size,
                        _TYPE_CODE[mesh.devices[0].type]],
                       dtype=torch.int64)
    all_sigs = _all_gather_int64(sig)
    base = all_sigs[0, 1:]
    for row in all_sigs:
        if not torch.equal(row[1:], base):
            raise RuntimeError(
                f"mesh mismatch across processes: process {int(row[0])} "
                f"sees {row[1:].tolist()}, process "
                f"{int(all_sigs[0, 0])} sees {base.tolist()}")
    # a fixed-length digest: axis names of any length gather at one shape
    digest = hashlib.sha256(mesh.axis_name.encode()).digest()
    names = _all_gather_int64(torch.tensor(list(digest), dtype=torch.int64))
    if not bool((names == names[0]).all()):
        raise RuntimeError("mesh axis names differ across processes")
