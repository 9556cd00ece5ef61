"""The trace reader on a made-up profiler trace whose device clock runs
ahead of the host's: each device operation still belongs to the call that
launched it, and the per-layer readers read what the calls did."""

import json

import pytest

from portbench import readers, trace_reader

SPAN = trace_reader.CALL_SPAN


def _x(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _trace(tmp_path):
    # two calls of 1,000 us; each launches one kernel 20 us in and waits
    # for it; the device clock reads 50 us early, so call 2's kernel
    # seems to start inside call 1's span
    events = [
        _x("user_annotation", SPAN, 0, 1000),
        _x("cuda_runtime", "cudaLaunchKernel", 20, 5, corr=1),
        _x("kernel", "k", -20, 900, corr=1),
        _x("cuda_runtime", "cudaStreamSynchronize", 30, 900),
        _x("user_annotation", SPAN, 1000, 1000),
        _x("cuda_runtime", "cudaLaunchKernel", 1010, 5, corr=2),
        _x("kernel", "k", 960, 950, corr=2),
        _x("cuda_runtime", "cudaStreamSynchronize", 1020, 940),
        # an operation the trace links to no host call counts by its own
        # start
        _x("gpu_memset", "Memset", 1970, 10),
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return trace_reader.summarize(trace_reader.read_trace(str(path)))


def test_device_work_belongs_to_the_launching_call(tmp_path):
    s = _trace(tmp_path)
    c1, c2 = s["calls"]
    assert c1["kernel_s"] == pytest.approx(900e-6)
    assert c2["kernel_s"] == pytest.approx(950e-6)
    assert c1["first_launch"] == pytest.approx(20e-6)
    assert c2["first_launch"] == pytest.approx(1010e-6)
    assert c1["last_cuda_end"] == pytest.approx(930e-6)
    assert c2["last_cuda_end"] == pytest.approx(1960e-6)
    assert s["window_s"] == pytest.approx(2000e-6)
    ctx = {"calls": s["calls"], "window_s": s["window_s"],
           "busy_s": s["busy_s"]}
    for c in ctx["calls"]:
        c["bound_s"] = 185e-6
    assert readers.kernels_roofline(ctx) == pytest.approx(
        100 * 370 / 1850)
    assert readers.host_prep_ms(ctx) == pytest.approx(15e-3)
    assert readers.host_tail_ms(ctx) == pytest.approx(55e-3)
    assert 0 < readers.idle_pct(ctx) < 100
