"""The port's multi-device layer (`parallel/`) and the distance `mesh=`
routes, on the CPU.

A mesh of the port is one process over a tuple of devices; on a CPU mesh
(`make_mesh(["cpu"] * D)`) every shard runs the kernels' plain PyTorch
versions.  `levenshtein_k_batch(mesh=)` must equal the meshless call, the
JAX package's mesh call on its virtual CPU devices and the scalar oracle
on each engine of the ladder (Myers, band, blocked, flat) at D = 1, 3 and
4; so must `levenshtein_exp_batch(mesh=)`, `hamming_batch(mesh=)` and
`match_count_psum`.  Also: `batch_sharding`, the mesh's device rules, the
order of launches and fetches in `run_sharded`, the halo rings, the
owner-by-end rule, and the cross-process assembly (`allgather_matches`,
`assert_mesh_consistent`) in two gloo processes that import no JAX.
Every plain-version tensor stays under 32,768 elements.
"""

import importlib
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from triple_accel_tpu.oracle import levenshtein_naive_k_with_opts
from triple_accel_tpu.parallel import make_mesh as jax_mesh
from triple_accel_tpu.types import EditCosts as JEditCosts

from triple_accel_tpu_torch import parallel as tp
from triple_accel_tpu_torch.dispatch import dispatch_history
from triple_accel_tpu_torch.types import EditCosts, Match, RDAMERAU_COSTS

# one intra-op thread: the test workers run side by side on the
# machine's cores
torch.set_num_threads(1)

jl = importlib.import_module("triple_accel_tpu.levenshtein")
jh = importlib.import_module("triple_accel_tpu.hamming")
tl = importlib.import_module("triple_accel_tpu_torch.levenshtein")
th = importlib.import_module("triple_accel_tpu_torch.hamming")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = dict(device="cpu")
AFFINE = (2, 1, 2, None)


def _mesh(D):
    return tp.make_mesh(["cpu"] * D)


def _pairs(seed, n, max_len, alpha=5):
    rng = np.random.default_rng(seed)
    a_list = [rng.integers(65, 65 + alpha, int(rng.integers(0, max_len)))
              .astype(np.uint8) for _ in range(n)]
    b_list = []
    for a in a_list:
        b = a.copy()
        if len(b) > 3:
            b[rng.integers(0, len(b), 2)] = 65
            b = np.delete(b, int(rng.integers(0, len(b))))
        if rng.random() < 0.3:
            b = rng.integers(65, 65 + alpha, int(rng.integers(0, max_len))) \
                .astype(np.uint8)
        b_list.append(b)
    a_list[1] = np.empty(0, np.uint8)  # an empty a: the blocked fix-up
    return a_list, b_list


def _oracle(a_list, b_list, k, c):
    out = []
    for a, b in zip(a_list, b_list):
        r = levenshtein_naive_k_with_opts(a, b, k, False, JEditCosts(*c))
        out.append(-1 if r is None else r[0])
    return np.array(out)


@pytest.mark.parametrize("engine,costs,k,jax_call", [
    ("myers", (1, 1, 0, None), 8, True),
    ("band", AFFINE, 12, True),
    ("myers_blocked_distance", (1, 1, 0, 1), 10**6, False),
    ("flat_distance", AFFINE, 40, False),
], ids=["myers", "band", "blocked", "flat"])
def test_k_batch_mesh_engines(monkeypatch, engine, costs, k, jax_call):
    """One engine for the whole batch, a block a device: mesh == meshless
    == oracle at D = 1, 3 and 4 (== the JAX mesh call at D = 4).  The
    blocked and flat engines are reached by taking the band plan away, as
    the JAX package's tests do."""
    a_list, b_list = _pairs(11, 22, 40)
    if engine in ("myers_blocked_distance", "flat_distance"):
        lb = importlib.import_module("triple_accel_tpu_torch.ops.lev_band")
        monkeypatch.setattr(lb, "band_plan", lambda *a, **kw: None)
    c = EditCosts(*costs)
    want = tl.levenshtein_k_batch(a_list, b_list, k, c, **CPU)
    for D in (1, 3, 4):
        dispatch_history(clear=True)
        got = tl.levenshtein_k_batch(a_list, b_list, k, c, mesh=_mesh(D),
                                     **CPU)
        assert [d.path for _, d in dispatch_history()] == [
            engine + "_sharded"]
        assert np.array_equal(got, want), D
    assert np.array_equal(want, _oracle(a_list, b_list, k, costs))
    if jax_call:
        ref = jl.levenshtein_k_batch(a_list, b_list, k, JEditCosts(*costs),
                                     mesh=jax_mesh(jax.devices()[:4]))
        assert np.array_equal(want, ref)


def test_k_batch_mesh_bucketed_stays_on_the_mesh():
    """A batch past 256 pairs splits into buckets; each bucket runs on the
    mesh (the recursion passes `mesh` on)."""
    rng = np.random.default_rng(12)
    # two length buckets of 260 pairs each (pow2 rows 8 and 32)
    a_list = [rng.integers(65, 70, int(rng.integers(4 + 13 * (p // 260),
                                                  8 + 22 * (p // 260))))
              .astype(np.uint8) for p in range(520)]
    b_list = [np.concatenate([a[1:], a[:2]]) for a in a_list]
    dispatch_history(clear=True)
    got = tl.levenshtein_k_batch(a_list, b_list, 6, mesh=_mesh(3), **CPU)
    paths = [d.path for _, d in dispatch_history()]
    assert len(paths) > 1 and set(paths) == {"myers_sharded"}
    assert np.array_equal(got, tl.levenshtein_k_batch(a_list, b_list, 6,
                                                      **CPU))


def test_exp_batch_mesh_equals_jax_and_oracle():
    a_list, b_list = _pairs(13, 16, 50)
    got = tl.levenshtein_exp_batch(a_list, b_list, RDAMERAU_COSTS,
                                   mesh=_mesh(4), **CPU)
    assert np.array_equal(got, tl.levenshtein_exp_batch(
        a_list, b_list, RDAMERAU_COSTS, **CPU))
    ref = jl.levenshtein_exp_batch(a_list, b_list,
                                   mesh=jax_mesh(jax.devices()[:4]))
    unit = tl.levenshtein_exp_batch(a_list, b_list, mesh=_mesh(3), **CPU)
    assert np.array_equal(unit, ref)
    assert np.array_equal(unit, _oracle(a_list, b_list, 10**6,
                                        (1, 1, 0, None)))


def test_hamming_batch_mesh_equals_jax():
    rng = np.random.default_rng(14)
    a = rng.integers(0, 3, (13, 10)).astype(np.uint8)
    b = rng.integers(0, 3, (13, 10)).astype(np.uint8)
    lengths = rng.integers(0, 11, 13).astype(np.int32)
    ref = jh.hamming_batch(a, b, lengths, mesh=jax_mesh(jax.devices()[:4]))
    for D in (1, 3, 4):
        got = th.hamming_batch(a, b, lengths, mesh=_mesh(D), **CPU)
        assert np.array_equal(got, ref), D


def test_match_count_psum_equals_jax():
    from triple_accel_tpu.parallel import match_count_psum as jax_psum

    rng = np.random.default_rng(15)
    dists = rng.integers(-1, 20, 64).astype(np.int32)
    ref = int(jax_psum(jax_mesh(jax.devices()[:4]), dists, 7))
    assert tp.match_count_psum(_mesh(4), dists, 7) == ref
    # one tensor, split on its own device without a trip through numpy
    assert tp.match_count_psum(_mesh(4), torch.from_numpy(dists), 7) == ref
    # per-device blocks of uneven sizes, one empty
    blocks = [torch.from_numpy(dists[:30]), torch.from_numpy(dists[30:30]),
              torch.from_numpy(dists[30:])]
    assert tp.match_count_psum(_mesh(3), blocks, 7) == ref


def test_batch_sharding():
    assert tp.batch_sharding(_mesh(4), 10) == [(0, 3), (3, 6), (6, 8),
                                               (8, 10)]
    assert tp.batch_sharding(_mesh(3), 2) == [(0, 1), (1, 2), (2, 2)]
    assert tp.batch_sharding(_mesh(1), 0) == [(0, 0)]
    assert tp.shard_bounds(10, 4) == [(0, 3), (3, 6), (6, 9), (9, 10)]
    assert tp.shard_bounds(2, 4) == [(0, 1), (1, 2), (2, 2), (2, 2)]
    assert tp.shard_bounds(0, 2) == [(0, 0), (0, 0)]


def test_mesh_device_rules():
    from triple_accel_tpu_torch.parallel.mesh import mesh_device

    mesh = tp.make_mesh(["cpu", torch.device("cpu"), "cpu"])
    assert mesh.size == 3 and mesh.axis_name == tp.DATA_AXIS
    assert set(mesh.devices) == {torch.device("cpu")}
    with pytest.raises(ValueError, match="mixes device types"):
        tp.make_mesh(["cpu", "cuda:0"])
    with pytest.raises(ValueError, match="at least one"):
        tp.make_mesh([])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tp.make_mesh(["cuda:0"] * 4)
    # a device= argument must be the mesh's first device
    assert mesh_device(mesh, "cpu") == torch.device("cpu")
    card = tp.Mesh((torch.device("cuda", 1),))
    with pytest.raises(ValueError, match="first device"):
        mesh_device(card, "cpu")
    with pytest.raises(ValueError, match="first device"):
        tl.levenshtein_k_batch([b"ab"], [b"ba"], 2, mesh=card, **CPU)
    with pytest.raises(TypeError, match="parallel.Mesh"):
        tl.levenshtein_k_batch([b"ab"], [b"ba"], 2, mesh=object(), **CPU)


def test_run_sharded_launches_every_shard_before_a_fetch():
    events = []

    def launch(blk, dev):
        events.append(("launch", blk))
        return torch.tensor([blk])

    def fetch(out):
        events.append(("fetch", int(out[0])))
        return int(out[0]) * 10

    got = tp.run_sharded(_mesh(3), launch, [1, None, 3], fetch)
    assert got == [10, None, 30]
    assert events == [("launch", 1), ("launch", 3), ("fetch", 1),
                      ("fetch", 3)]
    with pytest.raises(ValueError, match="2 blocks for a mesh of 3"):
        tp.run_sharded(_mesh(3), launch, [1, 2])


def test_halo_rings():
    hay = np.arange(10, dtype=np.uint8)
    mesh = _mesh(4)
    bounds = tp.shard_bounds(10, 4)
    from triple_accel_tpu_torch.parallel.sharded import upload_shards

    shards = upload_shards(mesh, hay, bounds)
    # a halo longer than a shard comes from several left neighbours
    got = [w.tolist() for w in tp.halo_windows(mesh, shards, 5)]
    assert got == [[0, 1, 2], [0, 1, 2, 3, 4, 5], [1, 2, 3, 4, 5, 6, 7, 8],
                   [4, 5, 6, 7, 8, 9]]
    got = [w.tolist() for w in tp.right_halo_windows(mesh, shards, 4)]
    assert got == [[0, 1, 2, 3, 4, 5, 6], [3, 4, 5, 6, 7, 8, 9],
                   [6, 7, 8, 9], [9]]
    wins = tp.HaloWindows(mesh, hay, 5)
    assert wins.halo_eff == [0, 3, 5, 5] and wins.owned_bytes(3) == 1
    view, h = wins.view(2, 2)  # cut on a 32-byte boundary: all of it
    assert view.tolist() == [1, 2, 3, 4, 5, 6, 7, 8] and h == 5
    with pytest.raises(ValueError, match="halo of 6 bytes"):
        wins.view(1, 6)


def test_collect_owned_hits():
    bounds = [(0, 4), (4, 8), (8, 10)]
    halo_eff = [0, 3, 3]
    hits = [
        (np.array([0, 3, 4, 5]), np.array([7, 8, 9, 10])),
        (np.array([2, 3, 4, 7, 8]), np.array([1, 2, 3, 4, 5])),
        (np.array([3, 4, 5, 6]), np.array([6, 7, 8, 9])),
    ]
    ends, vals = tp.collect_owned_hits(hits, halo_eff, bounds)
    # shard 0 owns ends 0..4, shard 1 ends 5..8, shard 2 ends 9..10
    assert ends.tolist() == [0, 3, 4, 5, 8, 9, 10]
    assert vals.tolist() == [7, 8, 9, 3, 4, 7, 8]
    ends, vals = tp.collect_owned_hits([hits[0], None, None], halo_eff,
                                       bounds)
    assert ends.tolist() == [0, 3, 4]


def test_multihost_in_one_process():
    ms = [Match(start=1, end=4, k=2), Match(start=7, end=9, k=0)]
    enc = tp.encode_matches(ms)
    assert enc.dtype == np.int64 and enc.tolist() == [[1, 4, 2], [7, 9, 0]]
    assert tp.decode_matches(enc) == ms
    assert tp.allgather_matches(ms) == ms and tp.allgather_matches([]) == []
    tp.assert_mesh_consistent(_mesh(2))  # one process: nothing to compare


_CHILD = r"""
import json, sys
import torch.distributed as dist
from triple_accel_tpu_torch.parallel import (
    allgather_matches, assert_mesh_consistent, make_mesh)
from triple_accel_tpu_torch.types import Match

path, rank = sys.argv[1], int(sys.argv[2])
dist.init_process_group("gloo", store=dist.FileStore(path, 2), rank=rank,
                        world_size=2)
out = {}
local = [Match(start=10 * rank + i, end=10 * rank + i + 3, k=i)
         for i in range(rank + 1)]
out["gathered"] = [[m.start, m.end, m.k] for m in allgather_matches(local)]
out["empty"] = len(allgather_matches([]))
assert_mesh_consistent(make_mesh(["cpu"] * 2))
for name, mesh in (("size", make_mesh(["cpu"] * (2 + rank))),
                   ("axis", make_mesh(["cpu"] * 2, "data" + "x" * rank))):
    try:
        assert_mesh_consistent(mesh)
        out[name] = "passed"
    except RuntimeError as e:
        out[name] = str(e)
dist.destroy_process_group()
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib",
                                                     "triple_accel_tpu")]
out["jax_modules"] = bad
print(json.dumps(out))
"""


def test_two_gloo_processes(tmp_path):
    """`allgather_matches` and `assert_mesh_consistent` across 2 gloo
    processes over a FileStore; a mesh size or axis name that differs
    between the ranks raises on both."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    store = str(tmp_path / "store")
    procs = [subprocess.Popen([sys.executable, "-c", _CHILD, store, str(r)],
                              cwd=str(tmp_path), env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=60)
            assert p.returncode == 0, err
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for out in outs:
        assert out["gathered"] == [[0, 3, 0], [10, 13, 0], [11, 14, 1]]
        assert out["empty"] == 0
        assert out["size"].startswith("mesh mismatch across processes")
        assert out["axis"] == "mesh axis names differ across processes"
        assert out["jax_modules"] == []
