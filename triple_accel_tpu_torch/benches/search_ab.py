"""End-to-end seconds of the meshless search entry points at chip_smoke.py's
search shapes, for comparing two versions of the port in one call.

    python3 -m triple_accel_tpu_torch.benches.search_ab [--tag NAME] [--reps N]

Run from the root of a checkout (it imports that checkout's package and
`chip_smoke.py` input generators), so a copy of an older commit unpacked
beside this one is timed by the same script, in its own process:

* `levenshtein_search_simd_with_opts`: the 24-byte needle over the 128
  MiB headline haystack at k = 3, unit and restricted-Damerau costs, Best
  and All (K2), and at k = 6 under `EditCosts(2, 1, 2)`, Best and All
  (K7), the haystack uploaded by every call;
* `levenshtein_search_many`: the dictionary phase's 512 short needles at
  k = 3, unit All, on one `PackedHaystack` (uploaded by a first call).

Each call runs once untimed, then `--reps` times.  Prints the card's name
and power limit, then one JSON line: the median, least and most seconds of
each call, and the match counts.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import time

import numpy as np
import torch


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tag", default="", help="a name for the JSON line")
    ap.add_argument("--reps", type=int, default=9)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("search_ab needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from triple_accel_tpu_torch.types import (
        EditCosts, LEVENSHTEIN_COSTS, RDAMERAU_COSTS, SearchType)
    from triple_accel_tpu_torch.utils import build

    lev = importlib.import_module("triple_accel_tpu_torch.levenshtein")
    print(cs.smi_line(), flush=True)
    build.load_kernels()
    needle, hay, _ = cs.make_haystack(cs.FULL_HAY_MB << 20)
    dhay, groups, _ = cs.make_dictionary(cs.FULL_HAY_MB << 20)
    ph = lev.PackedHaystack(dhay)
    general = EditCosts(*cs.GENERAL_COSTS[0])
    calls = {}
    for cname, costs, k in (("unit", LEVENSHTEIN_COSTS, cs.K_SEARCH),
                            ("rdamerau", RDAMERAU_COSTS, cs.K_SEARCH),
                            ("general", general, cs.K_GENERAL)):
        for st in (SearchType.Best, SearchType.All):
            calls[f"search_{cname}_{st.name}"] = (
                lambda costs=costs, k=k, st=st:
                lev.levenshtein_search_simd_with_opts(needle, hay, k, st,
                                                      costs, False))
    calls["dictionary_unit_All"] = lambda: lev.levenshtein_search_many(
        groups["short"], ph, cs.K_DICT, SearchType.All)

    out = {"tag": args.tag, "reps": args.reps, "seconds": {}, "matches": {}}
    for name, fn in calls.items():
        res = fn()
        secs = []
        for _ in range(args.reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        out["seconds"][name] = [round(float(np.median(secs)), 4),
                                round(min(secs), 4), round(max(secs), 4)]
        out["matches"][name] = (sum(len(r) for r in res)
                                if name.startswith("dictionary") else len(res))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
