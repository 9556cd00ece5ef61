"""Run cells of the benchmark several times, one process a run, and sum
up each metric's spread.

    python3 portbench/tools/run_sets.py --out runs/sets \
        --cells wfa10k.exact --seeds 11 12 13 --seconds 30 [--trace 1]

Each run is `portbench/run.py` as the benchmark's command runs it; its
standard output and error go to `<out>/<cell>.<seed>.t<trace>.<n>.out`
and `.err` (n: the run's place in the list of seeds).
One line a run is printed (exit code, correct, metrics), then a cell's
median, quartiles and spread (the distance between the first and third
quartile, `statistics.quantiles(values, n=4)`, as a share of the median)
of every metric over its runs.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi: {exc!r}"


def one_run(cell: str, seed: int, seconds: float, trace: int,
            out_dir: str, nth: int) -> dict:
    cmd = [sys.executable, os.path.join("portbench", "run.py"),
           "--workload", cell, "--seed", str(seed), "--seconds",
           str(seconds), "--trace", str(trace)]
    t0 = time.perf_counter()
    try:
        p = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                           timeout=1500)
        rc, so, se = p.returncode, p.stdout, p.stderr
    except subprocess.TimeoutExpired as exc:
        rc, so, se = 124, exc.stdout or "", exc.stderr or ""
        so = so if isinstance(so, str) else so.decode()
        se = se if isinstance(se, str) else se.decode()
    wall = time.perf_counter() - t0
    stem = os.path.join(out_dir, f"{cell}.{seed}.t{trace}.{nth}")
    with open(stem + ".out", "w") as fh:
        fh.write(so)
    with open(stem + ".err", "w") as fh:
        fh.write(se)
    res = None
    lines = so.strip().splitlines()
    if rc == 0 and lines:
        try:
            res = json.loads(lines[-1])
        except ValueError:
            res = None
    return {"cell": cell, "seed": seed, "trace": trace, "rc": rc,
            "wall_s": wall, "result": res,
            "earlier": lines[:-1][-4:], "err_tail": se[-1500:]}


def spread(values):
    med = statistics.median(values)
    if len(values) < 2:
        return med, med, med, 0.0
    q1, _, q3 = statistics.quantiles(values, n=4)
    return med, q1, q3, (q3 - q1) / med if med else 0.0


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--out", required=True)
    p.add_argument("--cells", nargs="+", required=True)
    p.add_argument("--seeds", nargs="+", type=int, required=True)
    p.add_argument("--seconds", type=float, default=30)
    p.add_argument("--trace", type=int, default=0)
    args = p.parse_args()
    os.makedirs(args.out, exist_ok=True)
    print("card:", card_line(), flush=True)
    summary = {}
    for cell in args.cells:
        runs = []
        for nth, seed in enumerate(args.seeds):
            r = one_run(cell, seed, args.seconds, args.trace, args.out, nth)
            res = r["result"] or {}
            print(json.dumps({
                "cell": cell, "seed": seed, "trace": args.trace,
                "rc": r["rc"], "wall_s": round(r["wall_s"], 2),
                "correct": res.get("correct"),
                "attempted": res.get("attempted"),
                "metrics": {k: v["value"] for k, v in
                            res.get("metrics", {}).items()},
                "device": res.get("device"),
                "breakdown": res.get("breakdown"),
                "checks": res.get("checks"),
                "earlier": r["earlier"]}), flush=True)
            if r["rc"] != 0 or not res:
                print("  stderr tail:", r["err_tail"], flush=True)
            runs.append(r)
        per_metric = {}
        for r in runs:
            for k, v in ((r["result"] or {}).get("metrics") or {}).items():
                per_metric.setdefault(k, []).append(v["value"])
        summary[cell] = {k: dict(zip(("median", "q1", "q3", "spread"),
                                     spread(v)), n=len(v))
                         for k, v in per_metric.items()}
    print("summary", json.dumps(summary), flush=True)
    print("card:", card_line(), flush=True)
    with open(os.path.join(args.out, "summary.json"), "w") as fh:
        json.dump(summary, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
