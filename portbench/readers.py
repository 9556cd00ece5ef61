"""The arithmetic the metric files share.  Each file under `end_to_end/`
and `metrics/` is one metric's `read`: with `run` (the run's record, see
`harness`: setup_s, window_s, latencies_s, work, per-call records,
launches a call, routes) or `ctx` (the traced window's summary, see
`trace_reader.summarize`: window_s, busy_s, per-call times each with its
bound_s, device seconds and bytes by name; the record under "record") it
returns the number, or None where it finds nothing to read."""

import numpy as np


def pairs_per_s(run):
    """Pairs of every call completed in the window over the window's
    seconds."""
    pairs = run["work"].get("pairs")
    return pairs / run["window_s"] if pairs else None


def batch_ms_p95(run):
    """The 95th percentile of every call's latency in the window (a call
    is one batch), in milliseconds."""
    lat = run["latencies_s"]
    return float(np.percentile(lat, 95)) * 1e3 if lat else None


def scan_GB_per_s(run):
    """Needles x reference bytes of every call completed in the window,
    over the window's seconds, in 1e9 bytes a second."""
    scanned = run["work"].get("needle_bytes_scanned")
    return scanned / run["window_s"] / 1e9 if scanned else None


def kernels_roofline(ctx):
    """The traced calls' share of their roofline: the frozen cost model's
    least time for each call (`cost_model`: the function's work, counted
    once, whatever kernels implement it), summed, over the device time of
    all kernels in those calls (the union of their intervals), in %."""
    calls = [c for c in ctx["calls"] if c.get("bound_s") is not None]
    kernel_s = sum(c["kernel_s"] for c in calls)
    if not kernel_s:
        return None
    return 100.0 * sum(c["bound_s"] for c in calls) / kernel_s


def idle_pct(ctx):
    """Share of the traced window in which no kernel, copy or memset ran
    on the device, in %."""
    if not ctx["window_s"]:
        return None
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["window_s"])


def host_prep_ms(ctx):
    """Mean over the traced calls of the time from the call's span start
    (the benchmark's, around the entry point) to the host's first launch
    or copy of the call's device work: the entry point's host prep
    (lists, bucketing, packing) before the card has work, in ms."""
    d = [c["first_launch"] - c["t0"] for c in ctx["calls"]
         if c["first_launch"] is not None]
    return 1e3 * sum(d) / len(d) if d else None


def host_tail_ms(ctx):
    """Mean over the traced calls of the time from the end of the call's
    last CUDA call on the host (its last launch, copy or wait) to its span
    end: the replay and post-processing after the card's last work, in
    ms."""
    d = [c["t1"] - c["last_cuda_end"] for c in ctx["calls"]
         if c["last_cuda_end"] is not None]
    return 1e3 * sum(d) / len(d) if d else None
