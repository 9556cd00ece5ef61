"""Rules the PyTorch/CUDA port keeps: it imports torch, never JAX and
nothing of the JAX package; it imports cleanly where there is no GPU, no
`nvcc` and no `triton`; and its entry points raise without a card instead
of moving to the CPU on their own."""

import ast
import importlib
import os
import pkgutil
import re
import subprocess
import sys

import pytest
import torch

import triple_accel_tpu_torch as tt

# one intra-op thread: the test workers run side by side on the
# machine's cores
torch.set_num_threads(1)

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
                "parallel.mesh", "parallel.sharded", "parallel.multihost",
                "utils.profiling", "utils.inspect_ir", "benches.gpu_fuzz"):
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


# Public surface: every public name of a JAX module (its `__all__`, or its
# public functions and classes, and the names it re-exports under another
# name) exists in the port's module of the same path (or in the port's
# modules named here, where the kernels' wrappers moved), or stands below
# with the reason it has no counterpart.
JAX_PKG = os.path.join(ROOT, "triple_accel_tpu")
_PORT_HOMES = {
    "ops/pallas/__init__.py": ["ops/__init__.py"],
    "ops/pallas/lev_band.py": ["ops/lev_band.py"],
    "ops/pallas/lev_myers.py": ["ops/myers_distance.py"],
    "ops/pallas/myers_chunked.py": ["ops/myers_chunked.py"],
    "ops/pallas/search_flat.py": ["ops/search_flat.py"],
    "ops/pallas/search_kernel.py": ["ops/search_diag.py"],
    "ops/pallas/search_myers.py": ["ops/myers_search.py",
                                   "ops/myers_chunked.py"],
    "ops/search_scan.py": ["ops/search_common.py"],
}
_TWO_PHASE = ("the TPU's two-phase hit fetch of 128-lane block minima; the "
              "port finds hits with torch.nonzero on the card")
_WRAPPER = "the TPU kernel's wrapper; the port's is "
_LANES = "the TPU's 128 lanes; the port's kernels pick their own lane maps"
_SHARD_MAP = ("a Pallas kernel under shard_map; the port runs each engine's "
              "own wrapper a shard (parallel.sharded.run_sharded)")
_RAW = ("a TPU window or segment layout; the port's kernels read the raw "
        "haystack (a shard's window) in place")
LEFT_OUT = {
    "BLOCK": _TWO_PHASE,
    "hamming_search_block_mins": _TWO_PHASE,
    "hamming_gather_blocks": _TWO_PHASE,
    "postprocess_hamming_native": "the port resolves Hamming hits on the "
                                  "card (hamming._resolve_counts_matches)",
    "LANES": _LANES,
    "PACK": "10 codes an int32 word, exact in f32 for the TPU's MXU; the "
            "port packs 16 (ops.band_scan.code_words)",
    "packed_code_rows": "code rows rounded to 8 sublanes; the port's are "
                        "ops.band_scan.code_words",
    "band_distance_pallas": _WRAPPER + "ops.lev_band.band_distance",
    "band_distance_pallas_tiled": _WRAPPER + "ops.lev_band.band_distance",
    "band_trace_pallas": _WRAPPER + "ops.lev_band.band_trace",
    "band_trace_pallas_tiled": _WRAPPER + "ops.lev_band.band_trace",
    "band_vmem_plan": "sized to the TPU's scoped VMEM; the port's plan is "
                      "ops.lev_band.band_plan",
    "prepare_pallas_inputs": "128-lane upload buffers; the port's are "
                             "ops.lev_band.prepare_band_tensors",
    "prepare_tiled_inputs": "VMEM row strips; the port's band kernels "
                            "stream the strings from device memory",
    "suggest_strip": "VMEM row strips; the port's band kernels stream the "
                     "strings from device memory",
    "suggest_trace_strip": "VMEM row strips of the traced kernel; the "
                           "port's streams its codes to device memory",
    "myers_chain_plan": "interleaved chains hide the TPU VPU's latency; K1 "
                        "runs one pair a thread",
    "myers_device_pack": "the TPU upload layout (4 chars an int32); the "
                         "port's is ops.myers_distance.prepare_myers_inputs",
    "myers_distance_pallas": _WRAPPER + "ops.myers_distance.myers_distance",
    "TC": "text columns a grid step on the TPU; K5 / K6 walk the text in "
          "one launch",
    "blocked_distance_chunked": _WRAPPER + "ops.myers_chunked."
                                           "blocked_distance",
    "blocked_search_chunked": _WRAPPER + "ops.myers_chunked.blocked_search",
    "blocked_search_chunked_mins": _TWO_PHASE,
    "blocked_search_chunked_mins_from_hay": _TWO_PHASE,
    "prepare_chunked_needles": "strip-major needle bands in 128 lanes; K6 "
                               "reads the needles as bytes",
    "RJ": "haystack columns a launch on the TPU; K8 walks its strips in "
          "one launch",
    "TI": "needle rows a grid step on the TPU; K8 / K9 keep a row in "
          "registers",
    "flat_search_gather_selected": "the dense-hit route's TPU form; the "
                                   "port's is levenshtein."
                                   "_flat_resolve_launch",
    "flat_search_mins": _TWO_PHASE,
    "flat_search_mins_from_hay": _TWO_PHASE,
    "windows_to_seg_lead": _RAW,
    "SBLOCK": _TWO_PHASE,
    "search_gather_blocks": _TWO_PHASE,
    "search_pallas": _WRAPPER + "ops.search_diag.search_diag",
    "search_pallas_block_mins": _TWO_PHASE,
    "blocked_search_block_mins": _TWO_PHASE,
    "blocked_search_pallas": _WRAPPER + "ops.myers_chunked.blocked_search",
    "blocked_seg_budget": "a segment budget of the TPU's VMEM; K6 sizes "
                          "segments by suggest_own_len_blocked",
    "device_grouped_transpose": _RAW,
    "device_pack_segs": _RAW,
    "device_windows": _RAW,
    "myers_blocked_plan": "the TPU's strip plan; the port's is "
                          "ops.myers_chunked.blocked_plan",
    "myers_search_block_mins_from_hay": _TWO_PHASE,
    "myers_search_pallas": _WRAPPER + "ops.myers_search.myers_search",
    "prepare_blocked_needles": "strip-major needle bands in 128 lanes; K6 "
                               "reads the needles as bytes",
    "prepare_blocked_search_inputs": _RAW,
    "prepare_myers_search_inputs": _RAW,
    "prepare_myers_segs": _RAW,
    "search_chain_plan": "interleaved chains hide the TPU VPU's latency; K2 "
                         "runs a lane a segment",
    "assemble_sharded_search": "stitches the TPU shards' owned (distance, "
                               "length) blocks; the port's shards return "
                               "hits (parallel.sharded.collect_owned_hits)",
    "collect_sharded_hits": "the TPU shards' two-phase hit fetch; the "
                            "port's is parallel.sharded.collect_owned_hits",
    "pad_batch_for_mesh": "pads a batch to 128-lane blocks and 2 grid steps "
                          "a device; the port's blocks are "
                          "parallel.mesh.batch_sharding's",
    "sharded_pack_segs": _RAW,
    "sharded_distance_step": _SHARD_MAP,
    "sharded_search_step": _SHARD_MAP,
    "sharded_band_distance": _SHARD_MAP,
    "sharded_blocked_search_mins": _SHARD_MAP,
    "sharded_chunked_distance": _SHARD_MAP,
    "sharded_chunked_search_mins": _SHARD_MAP,
    "sharded_flat_distance": _SHARD_MAP,
    "sharded_flat_search_mins": _SHARD_MAP,
    "sharded_hamming_search_mins": _SHARD_MAP,
    "sharded_myers_distance": _SHARD_MAP,
    "sharded_myers_search_mins": _SHARD_MAP,
    "sharded_myers_search_mins_packed": _SHARD_MAP,
}


def _jax_modules():
    out = []
    for base, _, files in os.walk(JAX_PKG):
        out += [os.path.relpath(os.path.join(base, f), JAX_PKG)
                for f in files if f.endswith(".py")]
    return sorted(out)


def _public_names(path):
    """A module's `__all__` (else its public functions and classes), and
    the names it re-exports from the package under another name."""
    tree = ast.parse(open(path, encoding="utf-8").read())
    names, listed = set(), False
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "__all__"
                for t in node.targets):
            names |= set(ast.literal_eval(node.value))
            listed = True
        elif isinstance(node, ast.ImportFrom) and node.level:
            names |= {a.asname for a in node.names
                      if a.asname and not a.asname.startswith("_")}
    if not listed:
        names |= {n.name for n in tree.body
                  if isinstance(n, (ast.FunctionDef, ast.ClassDef))
                  and not n.name.startswith("_")}
    return names


def _defined_names(path):
    """Names a module binds at top level; a package also its submodules."""
    if not os.path.exists(path):
        return set()
    tree = ast.parse(open(path, encoding="utf-8").read())
    out = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, ast.Assign):
            out |= {t.id for t in node.targets if isinstance(t, ast.Name)}
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                             ast.Name):
            out.add(node.target.id)
        elif isinstance(node, ast.ImportFrom):
            out |= {a.asname or a.name for a in node.names}
    if path.endswith("__init__.py"):
        out |= {os.path.splitext(f)[0]
                for f in os.listdir(os.path.dirname(path))}
    return out


@pytest.mark.parametrize("rel", _jax_modules())
def test_every_public_jax_name_is_ported_or_left_out_with_a_reason(rel):
    public = _public_names(os.path.join(JAX_PKG, rel))
    ported = set().union(*(_defined_names(os.path.join(PKG, home))
                           for home in [rel] + _PORT_HOMES.get(rel, [])))
    missing = sorted(public - ported - set(LEFT_OUT))
    assert not missing, f"{rel}: no counterpart and no reason: {missing}"
    if rel == "__init__.py":  # the reference's top-level callables
        assert {"hamming_fn", "levenshtein_fn"} <= public & ported


def test_names_left_out_have_no_counterpart():
    """The list stays true: each name on it is public in a JAX module and
    has no counterpart where that module's names go."""
    unported = set()
    for rel in _jax_modules():
        homes = [rel] + _PORT_HOMES.get(rel, [])
        unported |= _public_names(os.path.join(JAX_PKG, rel)) - set().union(
            *(_defined_names(os.path.join(PKG, h)) for h in homes))
    assert sorted(set(LEFT_OUT) - unported) == []
