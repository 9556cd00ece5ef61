"""Rules the PyTorch/CUDA port keeps: it imports torch, never JAX and
nothing of the JAX package; it imports cleanly where there is no GPU, no
`nvcc` and no `triton`; and its entry points raise without a card instead
of moving to the CPU on their own."""

import importlib
import os
import pkgutil
import re
import subprocess
import sys

import pytest
import torch

import triple_accel_tpu_torch as tt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "triple_accel_tpu_torch")


def _submodules():
    names = ["triple_accel_tpu_torch"]
    for mod in pkgutil.walk_packages([PKG], prefix="triple_accel_tpu_torch."):
        names.append(mod.name)
    return sorted(names)


def test_fresh_import_pulls_in_neither_jax_nor_the_jax_package():
    mods = _submodules()
    assert "triple_accel_tpu_torch.ops.myers_distance" in mods
    for new in ("ops.band_scan", "ops.lev_band", "ops.hamming_ops",
                "oracle.hamming", "hamming", "ops.myers_chunked",
                "ops.search_scan", "ops.search_diag", "ops.search_flat",
                "ops.trace_walk", "sweep", "utils.checkpoint", "parallel",
                "parallel.mesh", "parallel.sharded", "parallel.multihost"):
        assert f"triple_accel_tpu_torch.{new}" in mods
    assert "triple_accel_tpu_torch.utils.build" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'jaxlib' or m == 'triton' or m == 'triple_accel_tpu'"
        " or m.startswith('triple_accel_tpu.')]\n"
        "assert not bad, bad\n"
        "print('clean', len(sys.modules))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PATH"] = "/usr/bin:/bin"  # no nvcc on the way
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("clean")


def _python_sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for base, _, files in os.walk(PKG):
        if "_build" in base:
            continue
        out += [os.path.join(base, f) for f in files if f.endswith(".py")]
    return sorted(out)  # one order for every test worker


@pytest.mark.parametrize("path", _python_sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_source_imports_no_jax(path):
    src = open(path, encoding="utf-8").read()
    pat = re.compile(
        r"^\s*(import|from)\s+(jax|jaxlib|triple_accel_tpu)(\s|\.|$)",
        re.MULTILINE)
    assert not pat.search(src), pat.search(src).group(0)


@pytest.mark.parametrize("call", [
    lambda: tt.levenshtein(b"abc", b"ab"),
    lambda: tt.levenshtein_exp(b"abc", b"ab"),
    lambda: tt.levenshtein_k_batch([b"abc"], [b"ab"], 2),
    lambda: tt.levenshtein_exp_batch([b"abc"], [b"ab"]),
    lambda: tt.levenshtein_search(b"abc", b"xxabcxx"),
    lambda: tt.rdamerau(b"abc", b"acb"),
    lambda: tt.rdamerau_exp(b"abc", b"acb"),
    lambda: tt.levenshtein_k_batch([b"abc"], [b"ab"], 2, trace_on=True),
    lambda: sys.modules["triple_accel_tpu_torch.levenshtein"]
    .levenshtein_simd_k_str("abc", "ab", 1),
    # past the band plan, and past K2's 1280-char needles
    lambda: tt.levenshtein(b"a" * 5000, b"b" * 5100),
    lambda: tt.levenshtein_search(b"ab" * 700, b"ab" * 2000),
    # general costs: a search, and a long pair past the band plan
    lambda: sys.modules["triple_accel_tpu_torch.levenshtein"]
    .levenshtein_search_simd_with_opts(b"abc", b"xxabcxx", 1,
                                       tt.SearchType.All,
                                       tt.EditCosts(2, 1, 2, None)),
    lambda: tt.levenshtein_k_batch([b"a" * 5000], [b"b" * 5100], 10**6,
                                   tt.EditCosts(2, 1, 2, None)),
    # a traced long pair past the band plan
    lambda: tt.levenshtein_k_batch([b"a" * 5000], [b"b" * 5100], 10**6,
                                   trace_on=True),
    # dictionary search and the resumable sweep
    lambda: tt.levenshtein_search_many([b"abc", b"ab"], b"xxabcxx", 1),
    lambda: tt.PackedHaystack(b"xxabcxx"),
    lambda: importlib.import_module("triple_accel_tpu_torch.sweep")
    .levenshtein_search_sweep(b"abc", b"xxabcxx" * 10, 1, slab_chars=16),
    # the mesh layer: the default mesh is every visible card
    lambda: tt.parallel.make_mesh(),
    lambda: tt.levenshtein_search_sharded(b"abc", b"xxabcxx", 1),
    lambda: tt.hamming_search_sharded(b"abc", b"xxabcxx", 1),
])
def test_default_device_raises_without_a_card(call):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="cuda"):
        call()


def test_cuda_tensors_never_take_the_plain_version():
    """A wrapper chooses the plain version by where the tensor lies and by
    nothing else: asking for CUDA without a card fails at the device, not
    in a fallback."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        tt.levenshtein_k_batch([b"abc"], [b"ab"], 2, device="cuda")
    general = tt.EditCosts(3, 2, 1, 2)
    with pytest.raises(RuntimeError):
        sys.modules["triple_accel_tpu_torch.levenshtein"] \
            .levenshtein_search_simd_with_opts(
                b"abc", b"xxabcxx", 1, tt.SearchType.All, general,
                device="cuda")
    with pytest.raises(RuntimeError):
        tt.levenshtein_k_batch([b"a" * 5000], [b"b" * 5100], 10**6, general,
                               device="cuda")
    from triple_accel_tpu_torch.dispatch import resolve_device

    assert resolve_device("cpu").type == "cpu"
    assert tt.levenshtein(b"abc", b"ab", device="cpu") == 1
    with pytest.raises(RuntimeError):
        resolve_device()
    with pytest.raises(ValueError):
        resolve_device("meta")


@pytest.mark.parametrize("module,wrappers", [
    ("myers_distance", ["myers_distance"]),
    ("myers_search", ["myers_search"]),
    ("lev_band", ["band_distance", "band_trace"]),
    ("myers_chunked", ["blocked_distance", "blocked_search"]),
    ("search_diag", ["search_diag"]),
    ("search_flat", ["flat_search", "flat_distance"]),
    ("trace_walk", ["trace_walk"]),
])
def test_wrappers_take_the_plain_version_for_cpu_tensors_only(module,
                                                              wrappers):
    """Read from the source: a wrapper reaches its plain version on exactly
    one line, guarded by the tensor's device being the CPU; it refuses any
    device but CPU and CUDA; there is no `try` around the launch; and it
    counts a launch after `check_launch` only."""
    import importlib
    import inspect

    mod = importlib.import_module(f"triple_accel_tpu_torch.ops.{module}")
    for name in wrappers:
        fn = getattr(mod, name)
        assert fn.launches == 0 or isinstance(fn.launches, int)
        src = inspect.getsource(fn)
        assert src.count('.device.type == "cpu"') == 1
        assert src.count('.device.type != "cuda"') == 1
        assert "try:" not in src and "except" not in src
        cpu_at = src.index('.device.type == "cpu"')
        plain_at = min(src.index(p, cpu_at) for p in
                       ("_plain(", "band_scan_distance(",
                        "walk_packed_traceback(") if p in src[cpu_at:])
        assert plain_at - cpu_at < 80  # the very next statement
        assert src.index(".launches += 1") > src.index('!= "cuda"')
    launch_src = inspect.getsource(mod)
    assert "check_launch(" in launch_src and "load_kernels()" in launch_src


def test_band_wrappers_refuse_other_devices():
    from triple_accel_tpu_torch.ops import lev_band as lb

    import numpy as np

    t = lb.prepare_band_tensors([np.frombuffer(b"ab", np.uint8)],
                                [np.frombuffer(b"abc", np.uint8)], 4, 8,
                                device="cpu")
    meta = [x.to("meta") for x in t]
    ct = (1, 1, 0, 0, False)
    with pytest.raises(ValueError, match="unsupported device"):
        lb.band_distance(*meta, unit_k=4, costs_t=ct)
    with pytest.raises(ValueError, match="unsupported device"):
        lb.band_trace(*meta, unit_k=4, costs_t=ct)
    assert lb.band_distance.launches == 0 and lb.band_trace.launches == 0


def test_build_raises_without_nvcc(monkeypatch):
    from triple_accel_tpu_torch.utils import build

    if build.find_nvcc() is not None:
        pytest.skip("nvcc is present")
    with pytest.raises(RuntimeError, match="nvcc"):
        build.load_kernels()
    assert all(s.endswith(".cu") for s in build._sources())
    assert [os.path.basename(s) for s in build._sources()] == [
        "band_distance.cu", "myers_blocked.cu", "myers_distance.cu",
        "myers_search.cu", "search_diag.cu", "search_flat.cu",
        "trace_walk.cu"]
