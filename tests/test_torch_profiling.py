"""The port's `utils/profiling.py` and `utils/inspect_ir.py`, on the CPU.

`Throughput` and the JAX names of the cost model are held against the
JAX package's `utils/profiling.py`; the bound of every kernel against
PERF.md's bound column at the `chip_smoke.py` phases' fixed shapes (the
count moved out of `chip_smoke.py` and must not change); `trace` writes a
CPU trace naming its region; `inspect_ir` raises without the toolkit and
parses the compiler's report; `benches/band_sass.py` counts a loop of a
SASS excerpt.  No test here needs `nvcc` or a card.
"""

import doctest
import itertools
import json
import os
import time

import numpy as np
import pytest
import torch

import triple_accel_tpu.utils.profiling as jprof
from triple_accel_tpu_torch.benches import band_sass
from triple_accel_tpu_torch.utils import build, inspect_ir
from triple_accel_tpu_torch.utils import profiling as prof

# one intra-op thread: the test workers run side by side on the
# machine's cores
torch.set_num_threads(1)

MIB = 1 << 20


def _fake_clock(monkeypatch, step=0.25):
    ticks = itertools.count()
    monkeypatch.setattr(time, "perf_counter", lambda: next(ticks) * step)


def test_throughput_equals_the_jax_throughput(monkeypatch):
    reports = []
    for mod in (jprof, prof):
        _fake_clock(monkeypatch)
        t = mod.Throughput(extra={"note": 1.0})
        for pairs, nbytes in ((10, 1000), (0, 24), (7, 0)):
            with t.measure(pairs=pairs, bytes_processed=nbytes):
                pass
        reports.append((t.report(), t.pairs, t.bytes_processed))
    assert reports[0] == reports[1]
    assert reports[1][0]["pairs_per_sec"] == 17 / 0.75
    assert prof.Throughput().report() == {"pairs_per_sec": 0.0,
                                          "bytes_per_sec": 0.0,
                                          "seconds": 0.0}
    assert doctest.testmod(prof).failed == 0  # the Throughput doctest


def test_cost_estimates_return_the_jax_keys():
    for name, args in (("kernel_cost_estimate", (1024, 1000, 65)),
                       ("distance_kernel_cost_estimate", (32, 1000)),
                       ("search_kernel_cost_estimate", (24,))):
        got = getattr(prof, name)(*args)
        assert set(got) == set(getattr(jprof, name)(*args)), name
        assert all(v > 0 for v in got.values()), name
    # the card's rates: K2 bound by its 5 bytes a column, K1 by operations
    assert prof.search_kernel_cost_estimate(24)["ideal_bytes_per_sec"] \
        == pytest.approx(prof.PEAK_BYTES_PER_S / 5, rel=1e-8)
    one = prof.distance_kernel_cost_estimate(32, 1000)
    assert one["ideal_pairs_per_sec"] == pytest.approx(
        prof.PEAK_INT32_OPS_PER_S / (28 * 1000))
    assert prof.distance_kernel_cost_estimate(192, 1000)[
        "ideal_pairs_per_sec"] == 0.0  # past K1's three words


# PERF.md's bound column (ms, as printed) at the phases' fixed shapes
@pytest.mark.parametrize("kernel,bounds,expected", [
    ("K1", lambda: [prof.k1_bound(np.full(196_608, 1000), 32)], [0.3287]),
    ("K2", lambda: [prof.k2_bound(128 * MIB, 24, d) for d in (False, True)],
     [0.2003, 0.2003]),
    ("K6", lambda: [prof.k6_bound(128 * MIB, 3000, d)
                    for d in (False, True)], [8.3175, 11.3304]),
    ("K7", lambda: [prof.k7_bound(128 * MIB, 24, t) for t in (False, True)],
     [4.6155, 5.7694]),
    ("K8", lambda: [prof.k8_bound(16 * MIB, 3000, t) for t in (False, True)],
     [72.117, 90.1462]),
])
def test_bounds_reproduce_the_recorded_bound_column(kernel, bounds,
                                                    expected):
    got = bounds()
    assert [round(b["bound_ms"], 4) for b in got] == expected
    for b in got:
        assert b["bound_ms"] == max(b["bound_bytes_ms"],
                                    b["bound_operations_ms"])
        assert b["bound_by"] == ("bytes" if kernel == "K2"
                                 else "operations")


def test_trace_is_a_noop_without_a_directory(monkeypatch, tmp_path):
    monkeypatch.delenv("TRIPLE_ACCEL_TORCH_TRACE_DIR", raising=False)
    monkeypatch.chdir(tmp_path)
    with prof.trace("quiet_region"):
        torch.ones(4).add_(1)
    assert os.listdir(tmp_path) == []


@pytest.mark.parametrize("via", ["argument", "environment"])
def test_trace_writes_a_trace_naming_the_region(monkeypatch, tmp_path, via):
    out = tmp_path / "traces"
    if via == "environment":
        monkeypatch.setenv("TRIPLE_ACCEL_TORCH_TRACE_DIR", str(out))
    with prof.trace("fuzz/region 1", str(out) if via == "argument" else None):
        torch.arange(64).sum()
    files = os.listdir(out)
    assert len(files) == 1 and files[0].startswith("fuzz_region_1.")
    with open(out / files[0]) as fh:
        names = {e.get("name") for e in json.load(fh)["traceEvents"]}
    assert "fuzz/region 1" in names
    assert prof.device_time_by_name(str(out / files[0])) == {}  # no card


def test_inspect_ir_raises_without_the_toolkit(monkeypatch):
    monkeypatch.setattr(build, "find_nvcc", lambda: None)
    for compiled in (False, True):
        with pytest.raises(RuntimeError, match="nvcc"):
            inspect_ir.dump_lowered("myers_distance_kernel",
                                    compiled=compiled)
    with pytest.raises(RuntimeError, match="nvcc"):
        inspect_ir.dump_lowered("search_flat.cu")
    with pytest.raises(RuntimeError, match="nvcc"):
        inspect_ir.dump_flagship_kernels("unused")
    with pytest.raises(ValueError, match="no csrc"):
        inspect_ir.dump_lowered("no_such_kernel")


_PTXAS = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z11flat_kernelILb1ELb0ELi8EEv6SfArgs' for 'sm_90a'
ptxas info    : Function properties for _Z11flat_kernelILb1ELb0ELi8EEv6SfArgs
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 119 registers, used 1 barriers, 4224 bytes smem, 480 bytes cmem[0]
ptxas info    : Compiling entry function '_Z16band_wide_kernelILb0ELb0ELb0EEvPKh' for 'sm_90a'
ptxas info    : Function properties for _Z16band_wide_kernelILb0ELb0ELb0EEvPKh
    24 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 255 registers, 380 bytes cmem[0]
"""

_PTX = """\
.version 8.4
.target sm_90a
.visible .entry _Z11band_kernelILb1ELb0ELi9EEvPKh(
)
{ ret; }
.visible .entry _Z16band_wide_kernelILb0ELb0ELb0EEvPKh(
)
{ ret; }
"""


def test_inspect_ir_reads_the_sources_and_the_compilers_report():
    # every kernel of KERNELS is a __global__ function of one source
    for label, names in inspect_ir.KERNELS.items():
        for name in names:
            src, found = inspect_ir._source_of(name)
            assert found == [name] and src.endswith(".cu"), label
    _, every = inspect_ir._source_of("trace_walk.cu")
    assert every == ["trace_walk_gather_kernel", "trace_walk_kernel"]
    res = inspect_ir.ptxas_resources(_PTXAS)
    assert res["_Z11flat_kernelILb1ELb0ELi8EEv6SfArgs"] == {
        "stack_frame_bytes": 0, "spill_store_bytes": 0,
        "spill_load_bytes": 0, "registers": 119, "barriers": 1}
    assert res["_Z16band_wide_kernelILb0ELb0ELb0EEvPKh"]["spill_store_bytes"] \
        == 8
    lines = inspect_ir._resource_lines(_PTXAS, ["flat_kernel"])
    assert len(lines) == 4 and "119 registers" in lines[-1]
    assert not inspect_ir._mangled_match(
        "_Z16band_wide_kernelILb0ELb0ELb0EEvPKh", ["band_kernel"])
    only = inspect_ir._ptx_entries(_PTX, ["band_wide_kernel"])
    assert ".target sm_90a" in only and "band_wide_kernel" in only
    assert "_Z11band_kernel" not in only


_SASS = """\
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   S2R R0, SR_TID.X ;
        /*0020*/                   LDS R2, [R0] ;
        /*0030*/                   ISETP.GE.AND P0, PT, R2, R3, PT ;
        /*0040*/              @!P0 BRA 0x20 ;
        /*0050*/                   SHFL.UP PT, R4, R5, 0x1, RZ ;
        /*0060*/                   VIADDMNMX R6, R4, R7, R8, PT ;
        /*0070*/               @P1 BRA 0x90 ;
        /*0080*/                   STG.E [R10.64], R6 ;
        /*0090*/                   SHFL.UP PT, R4, R5, 0x2, RZ ;
        /*00a0*/                   ISETP.NE.AND P2, PT, R9, RZ, PT ;
        /*00b0*/               @P2 BRA 0x20 ;
        /*00c0*/                   EXIT ;
"""


def test_band_sass_counts_a_row_loop_of_a_sass_excerpt():
    # the spin loop [0x20, 0x40] holds no shuffle: the row loop is the
    # loop back from 0xb0, with the spin loop inside it
    (loop,) = band_sass._row_loops(_SASS, 3)
    assert loop["at"] == "0x20" and loop["instructions"] == 9
    assert loop["shuffles"] == 2 and loop["dpx_min"] == 1
    assert loop["spin_loops"] == 1
    assert loop["forward_branches"] == {"store": 1}
    assert loop["instructions_a_cell"] == 3.0
    # the innermost loop that shuffles, read as the column loops are read
    assert band_sass._column_loops(_SASS, 1) == []
