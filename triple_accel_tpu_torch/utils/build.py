"""Build and load the port's hand-written CUDA kernels.

`csrc/*.cu` is compiled with `nvcc` for `sm_90a` at first use, every
source to its own object (the compilers run side by side), and linked into
ONE shared library with a plain C interface, loaded with `ctypes`.  The
sources include no PyTorch header, so a build takes seconds.  The library
lands in `triple_accel_tpu_torch/_build/` under a name that carries a hash
of the sources and flags, so a stale library is never loaded.

Nothing here runs at import: `load_kernels()` is called by a kernel
wrapper's first launch.  Without `nvcc` it raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from typing import List, Optional

__all__ = ["load_kernels", "build_info", "find_nvcc", "check_launch"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_LIB: Optional[ctypes.CDLL] = None
_INFO: dict = {}


def find_nvcc() -> Optional[str]:
    """Path of `nvcc`, from PATH, $CUDA_HOME or /usr/local/cuda; or None."""
    cands = [shutil.which("nvcc")]
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root:
            cands.append(os.path.join(root, "bin", "nvcc"))
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    return None


def _sources() -> List[str]:
    return sorted(
        os.path.join(CSRC_DIR, f) for f in os.listdir(CSRC_DIR)
        if f.endswith(".cu")
    )


def _content_hash() -> str:
    h = hashlib.sha256()
    for f in sorted(os.listdir(CSRC_DIR)):
        if f.endswith((".cu", ".cuh")):
            h.update(f.encode())
            with open(os.path.join(CSRC_DIR, f), "rb") as fh:
                h.update(fh.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _build(lib_path: str) -> str:
    """Compile every source (in parallel) and link; returns the compilers'
    combined output (register / shared-memory report of `-Xptxas -v`)."""
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME, /usr/local/cuda): the CUDA "
            "kernels of triple_accel_tpu_torch cannot be built here"
        )
    os.makedirs(BUILD_DIR, exist_ok=True)
    log: List[str] = []
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in _sources():
            obj = os.path.join(
                tmp, os.path.splitext(os.path.basename(src))[0] + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-I", CSRC_DIR, "-c", src, "-o", obj]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        objs = []
        failed = []
        for src, obj, p in procs:
            out, _ = p.communicate()
            log.append(out)
            if p.returncode != 0:
                failed.append(f"{os.path.basename(src)}:\n{out}")
            objs.append(obj)
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp_lib = os.path.join(tmp, "lib.so")
        link = subprocess.run(
            [nvcc, "-shared", "-o", tmp_lib, *objs],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        log.append(link.stdout)
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + link.stdout)
        os.replace(tmp_lib, lib_path)  # atomic: readers see all or nothing
    return "".join(log)


def load_kernels(rebuild: bool = False) -> ctypes.CDLL:
    """The kernels' shared library, built first if this content hash has
    not been built yet — or in any case with `rebuild=True`, which is how
    a smoke run proves that the sources at hand compile.  Raises on any
    build or load failure."""
    global _LIB
    if _LIB is not None:
        return _LIB
    tag = _content_hash()
    lib_path = os.path.join(BUILD_DIR, f"libta_kernels_{tag}.so")
    t0 = time.perf_counter()
    built = False
    log = ""
    log_path = lib_path[:-len(".so")] + ".log"
    if rebuild or not os.path.exists(lib_path):
        log = _build(lib_path)
        built = True
        with open(log_path, "w") as fh:  # the report, for a later load
            fh.write(log)
    elif os.path.exists(log_path):
        with open(log_path) as fh:
            log = fh.read()
    lib = ctypes.CDLL(lib_path)
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.ta_myers_distance.restype = ctypes.c_int
    lib.ta_myers_distance.argtypes = [
        vp, vp, vp, vp, vp, vp, i64, i64, i64, i32, vp,
    ]
    lib.ta_myers_search.restype = ctypes.c_int
    lib.ta_myers_search.argtypes = [
        vp, i64, vp, i32, i32, i64, i64, i64, i32, i32, vp, i64, i32, i32,
        vp,
    ]
    lib.ta_band_distance.restype = ctypes.c_int
    lib.ta_band_distance.argtypes = [
        vp, vp, vp, vp, vp, vp, i64, i64, i64, i32, i64,
        i32, i32, i32, i32, i32, i32, i32, i32, vp,
    ]
    lib.ta_band_block.restype = ctypes.c_int
    lib.ta_band_block.argtypes = [
        vp, vp, vp, vp, vp, vp, i64, i64, i64, i32, i64,
        i32, i32, i32, i32, i32, i32, i32, vp,
    ]
    lib.ta_band_trace_cluster.restype = ctypes.c_int
    lib.ta_band_trace_cluster.argtypes = [
        vp, vp, vp, vp, vp, vp, i64, i64, i64, i32, i64,
        i32, i32, i32, i32, i32, i32, i32, i32, vp, vp,
    ]
    lib.ta_trace_walk.restype = ctypes.c_int
    lib.ta_trace_walk.argtypes = [
        vp, vp, vp, vp, vp, vp, vp, i64, i64, i64, i64, i64, i32, i64, i32,
        i32, i32, i32, vp,
    ]
    lib.ta_trace_walk_gather.restype = ctypes.c_int
    lib.ta_trace_walk_gather.argtypes = [vp, vp, vp, vp, i64, i64, vp]
    lib.ta_blocked_distance.restype = ctypes.c_int
    lib.ta_blocked_distance.argtypes = [
        vp, vp, vp, vp, vp, i32, i32, vp, i64, i64, i64, vp, i64, i32, vp,
    ]
    lib.ta_blocked_search.restype = ctypes.c_int
    lib.ta_blocked_search.argtypes = [
        vp, i64, vp, i32, i32, vp, i32, i32, i32, i32, i64, i64, i64, i32,
        i32, vp, i64, vp, i64, vp,
    ]
    lib.ta_search_diag.restype = ctypes.c_int
    lib.ta_search_diag.argtypes = [
        vp, i64, vp, i32, i64, i64, i64, i32, i32, i32, i32, i32, i32, i32,
        i32, i32, vp, vp, vp,
    ]
    lib.ta_flat_search.restype = ctypes.c_int
    lib.ta_flat_search.argtypes = [
        vp, i64, vp, i32, i64, i64, vp, i64, i32, i32, i32, i32, i32, i32,
        vp, vp, vp, i32, i32, vp,
    ]
    lib.ta_flat_distance.restype = ctypes.c_int
    lib.ta_flat_distance.argtypes = [
        vp, vp, vp, vp, i64, i64, i64, i32, i32, i32, i32, i32, i32, vp, vp,
        i32, i32, vp,
    ]
    lib.ta_cuda_error_string.restype = ctypes.c_char_p
    lib.ta_cuda_error_string.argtypes = [ctypes.c_int]
    _INFO.update(
        path=lib_path, built=built, seconds=time.perf_counter() - t0,
        sources=[os.path.relpath(s, os.path.dirname(_PKG))
                 for s in _sources()],
        compiler_output=log,
    )
    _LIB = lib
    return lib


def build_info() -> dict:
    """What the last `load_kernels()` did: library path, whether it was
    built in this process, seconds taken, sources, compiler output (that
    of the build that made the library, also when it was loaded from the
    build directory)."""
    return dict(_INFO)


def check_launch(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launch returned a non-zero cudaError_t."""
    if code != 0:
        msg = lib.ta_cuda_error_string(code)
        raise RuntimeError(
            f"{what}: CUDA launch failed with error {code} "
            f"({msg.decode() if msg else 'unknown'})"
        )
