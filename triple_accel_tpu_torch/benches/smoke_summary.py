"""Median (least - most) of every number in several `chip_smoke.py` logs.

    python3 chip_smoke.py > run1.log; python3 chip_smoke.py > run2.log; ...
    python3 -m triple_accel_tpu_torch.benches.smoke_summary run1.log run2.log ...

One run's kernel time is itself the median of several launches; runs differ
more than launches do (other machine, neighbours on the host), so a number
that is kept is the median over whole runs with its least and most.  Reads
only the JSON lines of the logs; needs no GPU.
"""

from __future__ import annotations

import json
import statistics
import sys
from typing import Dict, List


def _numbers(obj, prefix: str, out: Dict[str, float]) -> None:
    """Flatten the numeric leaves of a JSON value into `out` by path."""
    if isinstance(obj, bool) or obj is None:
        return
    if isinstance(obj, (int, float)):
        out[prefix] = obj
    elif isinstance(obj, dict):
        for key, val in obj.items():
            _numbers(val, f"{prefix}.{key}" if prefix else key, out)
    elif isinstance(obj, list):
        for i, val in enumerate(obj):
            _numbers(val, f"{prefix}[{i}]", out)


def read_run(path: str) -> Dict[str, float]:
    """All numbers of one log, keyed `phase[/regime].path` for phase lines
    and `kernel.<name>.path` for the entries of the `kernels` line."""
    out: Dict[str, float] = {}
    with open(path) as fh:
        for line in fh:
            if not line.startswith("{"):
                continue
            obj = json.loads(line)
            if "phase" in obj:
                tag = obj["phase"] + (
                    "/" + obj["regime"] if "regime" in obj else "")
                _numbers(obj, tag, out)
            elif "kernels" in obj:
                for k in obj["kernels"]:
                    _numbers(k, "kernel." + k["name"], out)
                    out[f"kernel.{k['name']}.ms_over_bound"] = (
                        k["ms"] / k["bound_ms"])
    return out


def summarise(paths: List[str]) -> List[str]:
    runs = [read_run(p) for p in paths]
    lines = []
    for key in runs[0]:
        vals = [r[key] for r in runs if key in r]
        lines.append(f"{key}: {statistics.median(vals):.6g} "
                     f"({min(vals):.6g} - {max(vals):.6g}) n={len(vals)}")
    return lines


def main(argv: List[str]) -> int:
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    print("\n".join(summarise(argv)))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
