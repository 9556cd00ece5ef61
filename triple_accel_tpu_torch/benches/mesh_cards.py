"""Every `mesh=` route on all the visible cards, and the cross-process
Match assembly over NCCL: the multi-card counterpart of chip_smoke.py's
`mesh` phase.

    python3 -m triple_accel_tpu_torch.benches.mesh_cards [--no-ranks]

Run from the root of a checkout (it imports `chip_smoke.py`).  It builds
the kernels, makes chip_smoke.py's inputs at their full widths (the
distance pairs, the 128 MiB search haystack, the dictionary's haystack
and 512 short needles, the `blocked_distance` and `flat_distance` pairs),
runs the meshless calls the `mesh` phase compares with, then
`chip_smoke.run_mesh`: every route on `make_mesh()` (every visible card)
and on 4 shards of card 0, each equal to the meshless call, with the
seconds of each route's second call.

With more than one card it then starts a process a card
(`torch.distributed`, NCCL, `tcp://localhost`) and holds
`allgather_matches` and `assert_mesh_consistent` across them: the
gathered list in rank order, an empty gather, and a mesh size or axis
name that differs between the ranks raising on every rank.

Prints the cards' names and power limits, then JSON lines.
"""

from __future__ import annotations

import argparse
import importlib
import json
import socket
import subprocess
import sys
import time

import torch


def rank_main(rank: int, world: int, port: int) -> int:
    """One rank of the NCCL check, on card `rank`."""
    import torch.distributed as dist

    from triple_accel_tpu_torch.parallel import (
        allgather_matches, assert_mesh_consistent, make_mesh)
    from triple_accel_tpu_torch.types import Match

    torch.cuda.set_device(rank)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    card = f"cuda:{rank}"
    out = {"rank": rank}
    local = [Match(start=10 * rank + i, end=10 * rank + i + 3, k=i)
             for i in range(rank + 1)]
    out["gathered"] = [[m.start, m.end, m.k]
                       for m in allgather_matches(local)]
    out["empty"] = len(allgather_matches([]))
    assert_mesh_consistent(make_mesh([card] * 2))
    for name, mesh in (("size", make_mesh([card] * (2 + rank))),
                       ("axis", make_mesh([card] * 2, "data" + "x" * rank))):
        try:
            assert_mesh_consistent(mesh)
            out[name] = "passed"
        except RuntimeError as e:
            out[name] = str(e)
    dist.destroy_process_group()
    out["jax_modules"] = [m for m in sys.modules if m.split(".")[0] in
                          ("jax", "jaxlib", "triple_accel_tpu")]
    print(json.dumps(out), flush=True)
    return 0


def run_ranks(world: int) -> dict:
    """`rank_main` in `world` processes, a card each; their outputs
    checked and returned."""
    import chip_smoke as cs

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "triple_accel_tpu_torch.benches.mesh_cards",
         "--rank", str(r), "--world", str(world), "--port", str(port)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=300)
            cs.check(p.returncode == 0, f"an NCCL rank failed: {err[-2000:]}")
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    want = [[10 * r + i, 10 * r + i + 3, i]
            for r in range(world) for i in range(r + 1)]
    for out in outs:
        cs.check(out["gathered"] == want and out["empty"] == 0,
                 f"rank {out['rank']} gathered {out['gathered']}")
        cs.check(out["size"].startswith("mesh mismatch across processes"),
                 f"rank {out['rank']}: a mesh size mismatch gave "
                 f"{out['size']}")
        cs.check(out["axis"] == "mesh axis names differ across processes",
                 f"rank {out['rank']}: an axis mismatch gave {out['axis']}")
        cs.check(out["jax_modules"] == [],
                 f"rank {out['rank']} imported {out['jax_modules']}")
    return {"phase": "ranks", "backend": "nccl", "world": world,
            "gathered": want, "mismatches_raised_on_every_rank": True,
            "seconds": round(time.perf_counter() - t0, 1)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--no-ranks", action="store_true",
                    help="skip the NCCL check across the cards")
    ap.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("mesh_cards needs a CUDA device", file=sys.stderr)
        return 2
    if args.rank is not None:
        return rank_main(args.rank, args.world, args.port)

    import chip_smoke as cs
    import triple_accel_tpu_torch as tt
    from triple_accel_tpu_torch.types import (
        LEVENSHTEIN_COSTS, RDAMERAU_COSTS, SearchType)
    from triple_accel_tpu_torch.utils import build

    lev = importlib.import_module("triple_accel_tpu_torch.levenshtein")
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    cards = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    print("\n".join(cards), flush=True)
    build.load_kernels(rebuild=True)

    # the inputs and the meshless results the mesh phase compares with
    a_list, b_list = cs.make_pairs(cs.FULL_PAIRS)
    k1_out = tt.levenshtein_k_batch(a_list, b_list, cs.K_DIST)
    needle, hay, _ = cs.make_haystack(cs.FULL_HAY_MB << 20)
    mono = {(cname, st): lev.levenshtein_search_simd_with_opts(
        needle, hay, cs.K_SEARCH, st, costs, False)
        for cname, costs in (("unit", LEVENSHTEIN_COSTS),
                             ("rdamerau", RDAMERAU_COSTS))
        for st in (SearchType.Best, SearchType.All)}
    dhay, groups, _ = cs.make_dictionary(cs.FULL_HAY_MB << 20)
    ph = lev.PackedHaystack(dhay)

    def dictionary():
        return lev.levenshtein_search_many(groups["short"], ph, cs.K_DICT,
                                           SearchType.All)

    dictionary()  # the upload, and a warm second call timed
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    unit_all = dictionary()
    torch.cuda.synchronize()
    dct = {"hay": dhay, "short": groups["short"], "unit_All": unit_all,
           "unit_All_s": time.perf_counter() - t0}
    pairs5, _ = cs.blocked_pairs(1.0)
    pairs9, _ = cs.flat_distance_pairs(1.0)
    cs.emit({"phase": "inputs", "cards": torch.cuda.device_count(),
             "matches": {f"{c}_{st.name}": len(v)
                         for (c, st), v in mono.items()},
             "dictionary_matches": sum(len(r) for r in unit_all),
             "seconds": round(time.perf_counter() - t_start, 1)})

    launches = cs.run_mesh(dev, a_list, b_list, k1_out, needle, hay, mono,
                           dct, pairs5, pairs9)
    cs.emit({"phase": "mesh_launches", "launches": {
        n: v for n, v in launches.items() if any(v.values())}})
    world = torch.cuda.device_count()
    if world > 1 and not args.no_ranks:
        cs.emit(run_ranks(world))
    print("\n".join(cards), flush=True)
    cs.emit({"ok": True, "seconds": round(time.perf_counter() - t_start, 1),
             "cards": world})
    return 0


if __name__ == "__main__":
    sys.exit(main())
