"""Reads a `torch.profiler` Chrome trace of a traced window into what the
per-layer metrics and the breakdown need.

Device operations are the trace's `kernel`, `gpu_memcpy` and `gpu_memset`
events; the benchmark's own spans are `user_annotation` events named
`CALL_SPAN`, one a call; the host's activity is every `cpu_op`,
`user_annotation` and `cuda_runtime` event.  Times are the trace's
microseconds.

Host and device timestamps come from two clocks that the profiler aligns
only to within some tens of microseconds, so a kernel launched right after
a call's span opens can appear to start before it.  A device operation
therefore belongs to the call whose span holds the host call that launched
it (the two events share the trace's `correlation` id), and per-call host
times are read on the host's clock alone.
"""

from __future__ import annotations

import json
from typing import Dict, List, Tuple

import numpy as np

__all__ = ["CALL_SPAN", "read_trace", "union_length", "summarize"]

CALL_SPAN = "portbench.call"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


def read_trace(path: str) -> dict:
    """{"device": [(start_us, end_us, name, cat, launch_us, bytes)],
    "host": [(start_us, end_us, name, cat)], "calls": [(start_us,
    end_us)]}, each sorted by start; `launch_us` is the start of the host
    call that launched the operation (its own start where the trace links
    none), `bytes` what a copy or memset moved (0 where the trace says
    nothing)."""
    with open(path) as fh:
        events = json.load(fh).get("traceEvents", [])
    device, host, calls, launch = [], [], [], {}
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat")
        ts = float(e.get("ts", 0.0))
        end = ts + float(e.get("dur", 0.0))
        args = e.get("args") or {}
        corr = args.get("correlation")
        if cat in DEVICE_CATS:
            device.append((ts, end, e.get("name", "?"), cat, corr,
                           int(args.get("bytes", 0) or 0)))
        elif cat in HOST_CATS:
            host.append((ts, end, e.get("name", "?"), cat))
            if cat in ("cuda_runtime", "cuda_driver") and corr is not None:
                launch[corr] = ts
            if cat == "user_annotation" and e.get("name") == CALL_SPAN:
                calls.append((ts, end))
    device = [(s, e, n, c, launch.get(corr, s), nb)
              for s, e, n, c, corr, nb in device]
    device.sort()
    host.sort()
    calls.sort()
    return {"device": device, "host": host, "calls": calls}


def union_length(iv: List[Tuple[float, float]], lo: float = -np.inf,
                 hi: float = np.inf) -> float:
    """Length of the union of intervals, clipped to [lo, hi]."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(iv):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def _gaps(iv, lo: float, hi: float) -> List[Tuple[float, float]]:
    """The stretches of [lo, hi] that no interval covers."""
    out, t = [], lo
    for s, e in sorted(iv):
        if s > t:
            out.append((t, min(s, hi)))
        t = max(t, e)
        if t >= hi:
            break
    if t < hi:
        out.append((t, hi))
    return [(a, b) for a, b in out if b > a]


def _label(host, starts: np.ndarray, mid: float, calls) -> str:
    """What the host was doing at `mid`: the innermost host event that
    covers it, or whether it lay inside a call span."""
    i = int(np.searchsorted(starts, mid, side="right")) - 1
    for j in range(i, max(i - 2000, -1), -1):
        s, e, name, cat = host[j]
        if e >= mid and not (cat == "user_annotation" and name == CALL_SPAN):
            return name
    inside = any(s <= mid <= e for s, e in calls)
    return "python, in a call" if inside else "between calls"


def summarize(tr: dict) -> dict:
    """Per-call times (seconds) and the window's busy time, idle gaps and
    device operations.  The window runs from the first call span's start
    to the last one's end.  A call's `first_launch` is the host's first
    launch or copy of its device work, `last_cuda_end` the end of the
    last CUDA call the host made inside its span (its last launch, copy
    or wait), `kernel_s` the union of its kernels' device intervals.
    Besides the breakdown's ten longest, every device operation's seconds
    in the window by name (`device_s_by_name`), and the bytes that copies
    and memsets moved by name (`bytes_by_name`)."""
    calls = tr["calls"]
    device = tr["device"]
    if not calls:
        return {"calls": [], "window_s": 0.0, "busy_s": 0.0,
                "device_ops": [], "idle_gaps": [], "device_s_by_name": {},
                "bytes_by_name": {}}
    lo, hi = calls[0][0], calls[-1][1]
    in_win = [d for d in device if d[1] > lo and d[0] < hi]
    busy = union_length([d[:2] for d in in_win], lo, hi)
    by_launch = sorted(device, key=lambda d: d[4])
    l_starts = np.array([d[4] for d in by_launch])
    host = tr["host"]
    cuda = [h for h in host if h[3] in ("cuda_runtime", "cuda_driver")]
    c_starts = np.array([h[0] for h in cuda])
    per_call = []
    for c0, c1 in calls:
        a, b = np.searchsorted(l_starts, [c0, c1], side="left")
        mine = by_launch[a:b]
        ca, cb = np.searchsorted(c_starts, [c0, c1], side="left")
        kern = [d[:2] for d in mine if d[3] == "kernel"]
        per_call.append({
            "t0": c0 * 1e-6, "t1": c1 * 1e-6,
            "first_launch": mine[0][4] * 1e-6 if mine else None,
            "last_cuda_end": (max(min(h[1], c1) for h in cuda[ca:cb]) * 1e-6
                              if cb > ca else None),
            "kernel_s": union_length(kern) * 1e-6,
        })
    by_name: Dict[str, float] = {}
    moved: Dict[str, int] = {}
    for s, e, name, _, _, nb in in_win:
        by_name[name] = by_name.get(name, 0.0) + (min(e, hi) - max(s, lo))
        if nb:
            moved[name] = moved.get(name, 0) + nb
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    h_starts = np.array([h[0] for h in host]) if host else np.zeros(0)
    gaps: Dict[str, float] = {}
    for g0, g1 in _gaps([d[:2] for d in in_win], lo, hi):
        lab = _label(host, h_starts, 0.5 * (g0 + g1), calls)
        gaps[lab] = gaps.get(lab, 0.0) + (g1 - g0)
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return {
        "calls": per_call,
        "window_s": (hi - lo) * 1e-6,
        "busy_s": busy * 1e-6,
        "device_ops": [[n, v * 1e-6] for n, v in ops],
        "idle_gaps": [[n, v * 1e-6] for n, v in idle],
        "device_s_by_name": {n: v * 1e-6 for n, v in by_name.items()},
        "bytes_by_name": moved,
    }
