"""One run of one cell: set-up, the measured window, the traced window,
the check against the reference, the result.

Everything that belongs to one cell is found by name: the workload entry
and the metric entries in `BENCHMARK.json`, the configuration file it
names, `mixes/<traffic>.json`, the mix's kind `kinds/<kind>.py` (inputs,
entry point, work, least time, reference answers), `end_to_end/<metric>.py`
and `metrics/<metric>.py` (each a `read` that returns a number, or None
where it finds nothing to read).  Nothing here branches on a kind, a mix
or a metric: a new cell, mix, kind or metric is new files and new entries.

End-to-end readers get the run's record (`run_cell` builds it: set-up and
window seconds, every call's latency, batch and work, the work summed,
launches a call, the warm call's routes); per-layer readers get the
traced window's whole summary (`trace_reader.summarize`, each call with
its least time `bound_s`) with that record under "record".
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
import tempfile
import time
from dataclasses import dataclass
from typing import Callable, List, Optional

import numpy as np

from . import check, trace_reader

__all__ = ["BENCH_DIR", "ROOT", "Cell", "find_cell", "run_cell",
           "FORBIDDEN_MODULES", "forbidden_loaded"]

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
# top-level module names that no run may have loaded once its window has
# closed: the JAX package and JAX itself (names compared whole)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "triple_accel_tpu")


def forbidden_loaded() -> List[str]:
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN_MODULES))


def _load_json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


@dataclass
class Cell:
    workload: dict
    config: dict
    mix: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    root: str = ROOT

    @property
    def name(self) -> str:
        return self.workload["name"]

    def module(self, section: str, name: str):
        """`<root>/portbench/<section>/<name>.py`, loaded by its path."""
        path = os.path.join(self.root, "portbench", section, name + ".py")
        spec = importlib.util.spec_from_file_location(
            "portbench_" + section + "_" + name.replace(".", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    def reader(self, section: str, metric: str) -> Callable:
        return self.module(section, metric).read

    @property
    def kind(self):
        """The mix's kind of traffic, `kinds/<kind>.py`."""
        if getattr(self, "_kind", None) is None:
            self._kind = self.module("kinds", self.mix["kind"])
        return self._kind


def find_cell(workload: str, root: str = ROOT) -> Cell:
    """The cell `workload` of `<root>/BENCHMARK.json` with its files."""
    spec = _load_json(os.path.join(root, "BENCHMARK.json"))
    wl = next((w for w in spec["workloads"] if w["name"] == workload), None)
    if wl is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in spec["configs"] if c["name"] == wl["config"])
    config = _load_json(os.path.join(root, conf["file"]))
    mix = _load_json(os.path.join(root, "portbench", "mixes",
                                  wl["traffic"] + ".json"))

    def applies(m: dict, names) -> bool:
        return workload in m["workloads"] if "workloads" in m else names

    e2e = [m for m in spec["end_to_end"] if applies(m, True)]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if applies(m, m["moves"] in e2e_names)]
    return Cell(wl, config, mix, e2e, per_layer, root)


# ---------------------------------------------------------------------------
# the program under test
# ---------------------------------------------------------------------------

def launch_counts() -> dict:
    """Every kernel wrapper's launch counter in the program's `ops`."""
    import pkgutil

    import triple_accel_tpu_torch.ops as ops

    out = {}
    for info in pkgutil.iter_modules(ops.__path__):
        mod = sys.modules.get(f"{ops.__name__}.{info.name}")
        if mod is None:
            continue
        for name, obj in vars(mod).items():
            n = getattr(obj, "launches", None)
            if callable(obj) and isinstance(n, int):
                out[f"{info.name}.{name}"] = n
    return out


def routes() -> dict:
    """The dispatch decisions since the last look (the program keeps the
    last 64), counted by routine and path."""
    from triple_accel_tpu_torch.dispatch import dispatch_history

    out: dict = {}
    for routine, dec in dispatch_history(clear=True):
        key = f"{routine}:{dec.path}"
        out[key] = out.get(key, 0) + 1
    return out


# ---------------------------------------------------------------------------
# one run
# ---------------------------------------------------------------------------

def _window(call: Callable, inputs, seconds: float, span: bool,
            keep: Callable):
    """Calls in a closed loop, each on the next batch, until `seconds`
    have passed since the first began; a call that raises counts as
    failed.  Returns ((batch, keep(batch, output)) a call, latencies,
    window seconds, failed)."""
    from torch.profiler import record_function

    outputs, lat, failed = [], [], 0
    n_b = len(inputs.batches)
    t_first = time.perf_counter()
    t_last = t_first
    c = 0
    while time.perf_counter() - t_first < seconds:
        b = c % n_b
        t0 = time.perf_counter()
        try:
            if span:
                with record_function(trace_reader.CALL_SPAN):
                    out = call(inputs.batches[b])
            else:
                out = call(inputs.batches[b])
        except Exception as exc:  # a failed call is counted, not fatal
            print(f"call {c} failed: {exc!r}", file=sys.stderr)
            out = None
            failed += 1
        t_last = time.perf_counter()
        lat.append(t_last - t0)
        outputs.append((b, keep(b, out)))
        c += 1
    return outputs, lat, t_last - t_first, failed


def _device_info(device, chips: int) -> dict:
    import torch

    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    peak = max(torch.cuda.max_memory_allocated(d) for d in range(chips))
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips, "memory_peak_bytes": int(peak)}


def _traced_window(call, inputs, seconds, keep):
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        res = _window(call, inputs, seconds, True, keep)
    fd, path = tempfile.mkstemp(suffix=".json", prefix="portbench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        summary = trace_reader.summarize(trace_reader.read_trace(path))
    finally:
        os.remove(path)
    return res, summary


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, *,
             device="cuda", t_start: Optional[float] = None,
             wrap: Optional[Callable] = None, control: bool = False,
             emit=print) -> dict:
    """One run of `cell`: the result object the last line of a run prints.
    `wrap(call) -> call` puts a fault under the timed path (tests only);
    `control` puts the kind's control in the program's place; `emit`
    takes the earlier lines."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    kind = cell.kind
    chips = int(cell.workload["chips"])
    inputs = kind.make_inputs(cell, seed)
    per_call = kind.answers_per_call(inputs)
    sample = check.draw_sample(inputs, per_call,
                               int(cell.mix["reference_sample"]), seed)
    sampled: dict = {}
    for b, i in sample:
        sampled.setdefault(b, []).append(i)

    def keep(b, out):
        return (None if out is None
                else kind.keep(out, sampled.get(b, ())))

    if control:
        call = kind.open_control(cell, inputs, device, sampled)
    else:
        call = kind.open_program(cell, inputs, device)
    if wrap is not None:
        call = wrap(call)
    # set-up ends with one call at the cell's own shapes
    routes()
    call(inputs.batches[0])
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    warm_routes = routes()
    emit(json.dumps({"routes_of_the_warm_call": warm_routes}))
    before = launch_counts()
    setup_s = time.perf_counter() - t_start

    if trace:
        window_s_max = min(seconds, float(cell.mix.get("trace_seconds",
                                                       seconds)))
        (outputs, lat, window_s, failed), summary = _traced_window(
            call, inputs, window_s_max, keep)
    else:
        outputs, lat, window_s, failed = _window(call, inputs, seconds,
                                                 False, keep)
        summary = None
    calls = len(outputs)
    after = launch_counts()
    launches = {k: (after[k] - before.get(k, 0)) / max(calls, 1)
                for k in sorted(after) if after[k] != before.get(k, 0)}
    emit(json.dumps({"launches_per_call": launches}))
    device_info = _device_info(device, chips)
    found = forbidden_loaded()
    if found:
        raise RuntimeError(f"modules of JAX or the JAX package loaded: "
                           f"{found}")

    per_call_rec, work = [], {}
    for (b, rec), t in zip(outputs, lat):
        w = kind.work(cell, inputs, b, rec) if rec is not None else {}
        for key, v in w.items():
            work[key] = work.get(key, 0) + v
        per_call_rec.append({"batch": b, "latency_s": t, "work": w,
                             "failed": rec is None})
    record = {"setup_s": setup_s, "window_s": window_s,
              "latencies_s": lat, "work": work, "calls": per_call_rec,
              "attempted": calls, "failed": failed,
              "launches_per_call": launches,
              "routes_of_the_warm_call": warm_routes}
    metrics = {}
    breakdown = None
    if trace:
        for c, (b, rec) in zip(summary["calls"], outputs):
            c["batch"] = b
            c["bound_s"] = (kind.bound(cell, inputs, b, rec)["bound_s"]
                            if rec is not None else None)
        ctx = dict(summary, record=record)
        sections = [("metrics", cell.per_layer, ctx)]
        device_info["busy_s"] = summary["busy_s"]
        device_info["window_s"] = summary["window_s"]
        breakdown = {"device_ops": summary["device_ops"],
                     "idle_gaps": summary["idle_gaps"]}
    else:
        sections = [("end_to_end", cell.end_to_end, record)]
    for section, entries, arg in sections:
        for m in entries:
            v = cell.reader(section, m["name"])(arg)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}

    # the check: the program's state freed first, so that the reference
    # sets no peak and has the card to itself
    del call
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    expected = kind.expected(cell, inputs, sample, device)
    compared, mismatched = check.count_mismatches(outputs, expected,
                                                  per_call)
    thirds = [float(np.median(p)) * 1e3 for p in np.array_split(lat, 3)
              if len(p)]
    emit(json.dumps({"check": {"calls": calls, "answers_compared": compared,
                               "sample": len(sample),
                               "reference_s": time.perf_counter() - t_ref,
                               "window_s": window_s,
                               "control": control,
                               "call_ms_median_by_third": thirds}}))
    checks = {"mismatched_answers": {"value": mismatched, "limit": 0},
              "failed_calls": {"value": failed, "limit": 0}}
    correct = (compared > 0 and mismatched <= 0 and failed <= 0)
    result = {"correct": bool(correct), "attempted": calls,
              "failed": failed, "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result
