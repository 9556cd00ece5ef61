"""Dump the PTX and SASS of the port's kernels (build_ir_asm.sh analog).

Own counterpart, for the PyTorch/CUDA port, of the JAX package's
`utils/inspect_ir.py`.  The reference ships `build_ir_asm.sh` to emit the
LLVM IR and assembly of its SIMD cores; the JAX package dumps StableHLO
and XLA's compiled HLO.  Here the two forms are a CUDA source's PTX (what
`nvcc` hands the assembler) and the SASS of the kernels in the library
that `utils/build.py` links (what the card runs), with the assembler's
resource report (`-Xptxas -v`: registers, stack frame, spill bytes).

Usage (library):

    from triple_accel_tpu_torch.utils.inspect_ir import dump_lowered
    text = dump_lowered("flat_kernel", compiled=True)

Usage (CLI: both forms of every kernel, K1 to K10, into ./ir_dump/):

    python -m triple_accel_tpu_torch.utils.inspect_ir [outdir]

Needs the CUDA toolkit (`nvcc`, `cuobjdump`, `c++filt`), not a device;
without `nvcc` or `cuobjdump` it raises, as `utils/build.py` does.
"""

from __future__ import annotations

import functools
import json
import os
import re
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

from . import build

__all__ = [
    "KERNELS",
    "dump_lowered",
    "dump_flagship_kernels",
    "function_names",
    "ptxas_resources",
    "resources_by_kernel",
    "sass_functions",
]

# Every kernel of the port, by the names the chip run and PERF.md give
# them: the `__global__` functions that run each one.
KERNELS: Dict[str, Tuple[str, ...]] = {
    "K1": ("myers_distance_kernel",),
    "K2": ("myers_search_kernel",),
    "K3/K4": ("band_kernel", "band_block_kernel", "band_cluster_kernel"),
    "K5/K6": ("blocked_kernel",),
    "K7": ("search_diag_kernel",),
    "K8/K9": ("flat_kernel",),
    "K10": ("trace_walk_kernel", "trace_walk_gather_kernel"),
}


def _toolkit() -> Tuple[str, str]:
    """(nvcc, cuobjdump) of the CUDA toolkit, or RuntimeError."""
    nvcc = build.find_nvcc()
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME, /usr/local/cuda): the PTX "
            "and SASS of triple_accel_tpu_torch's kernels need the CUDA "
            "toolkit")
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    if not os.access(cuobjdump, os.X_OK):
        raise RuntimeError(f"cuobjdump not found beside {nvcc}")
    return nvcc, cuobjdump


def _is_source(kernel: str) -> bool:
    return os.path.isfile(os.path.join(
        build.CSRC_DIR, kernel if kernel.endswith(".cu") else kernel + ".cu"))


def _globals_of(src: str) -> List[str]:
    """The `__global__` functions a source defines."""
    with open(src) as fh:
        text = fh.read()
    names = set()
    for decl in re.findall(r"__global__([^;{]*)", text):
        decl = re.sub(r"__launch_bounds__\s*\((?:[^()]|\([^()]*\))*\)", "",
                      decl)
        names.add(re.search(r"(\w+)\s*\(", decl).group(1))
    return sorted(names)


def _source_of(kernel: str) -> Tuple[str, List[str]]:
    """(source path, kernel names) for a `csrc/*.cu` name (with or without
    `.cu`: every kernel it defines) or a kernel's name."""
    if _is_source(kernel):
        src = os.path.join(build.CSRC_DIR, kernel if kernel.endswith(".cu")
                           else kernel + ".cu")
        return src, _globals_of(src)
    for src in build._sources():
        if kernel in _globals_of(src):
            return src, [kernel]
    raise ValueError(f"{kernel!r} names no csrc/*.cu source and no "
                     f"__global__ function of one")


def _mangled_match(mangled: str, names: List[str]) -> bool:
    """Whether an Itanium-mangled symbol is one of the global functions
    `names` (any instantiation): `_Z<length><name>`, then its template
    or parameter list."""
    return any(mangled.startswith(f"_Z{len(n)}{n}") for n in names)


def _ptx_flags() -> List[str]:
    """`utils/build.py`'s flags, with PTX of the virtual sm_90a target and
    no host or assembler options."""
    out, skip = [], False
    for f in build.NVCC_FLAGS:
        if skip:
            skip = False
            continue
        if f in ("-Xcompiler", "-Xptxas"):
            skip = True
            continue
        out.append(f.replace("code=sm_90a", "code=compute_90a"))
    return out


def _ptx(src: str) -> str:
    nvcc, _ = _toolkit()
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "k.ptx")
        res = subprocess.run(
            [nvcc, *_ptx_flags(), "-I", build.CSRC_DIR, "-ptx", src, "-o",
             out], capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc -ptx {os.path.basename(src)} failed:"
                               f"\n{res.stdout}{res.stderr}")
        with open(out) as fh:
            return fh.read()


def _ptx_entries(ptx: str, names: List[str]) -> str:
    """The PTX module's header (everything before its first entry) and the
    entries of the functions `names`."""
    starts = [m.start() for m in re.finditer(
        r"^(?:\.visible\s+|\.weak\s+)?\.entry\s", ptx, re.M)]
    if not starts:
        return ptx
    keep = [ptx[:starts[0]]]
    for a, b in zip(starts, starts[1:] + [len(ptx)]):
        name = re.match(r"[^\n]*?\.entry\s+(\w+)", ptx[a:b]).group(1)
        if _mangled_match(name, names):
            keep.append(ptx[a:b])
    return "".join(keep)


def ptxas_resources(log: str) -> Dict[str, dict]:
    """Mangled entry name -> registers, stack frame and spill bytes,
    barriers, from the assembler's `-v` report."""
    out: Dict[str, dict] = {}
    cur = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = m.group(1)
            out[cur] = {}
        elif cur and "spill stores" in line:
            nums = [int(x) for x in re.findall(r"(\d+) bytes", line)]
            out[cur]["stack_frame_bytes"] = nums[0]
            out[cur]["spill_store_bytes"] = nums[1]
            out[cur]["spill_load_bytes"] = nums[2]
        elif cur and "Used" in line and "registers" in line:
            out[cur]["registers"] = int(
                re.search(r"Used (\d+) registers", line).group(1))
            bar = re.search(r"used (\d+) barriers", line)
            out[cur]["barriers"] = int(bar.group(1)) if bar else 0
    return out


def resources_by_kernel(log: str) -> Dict[str, dict]:
    """`ptxas_resources` keyed by the demangled instantiation (its return
    type and arguments cut off), e.g. "flat_kernel<true, false, 8>"."""
    regs = ptxas_resources(log)
    names = list(regs)
    return {d.split(" ", 1)[-1]: regs[n]
            for n, d in zip(names, _demangle(names))}


def _demangle(names: List[str]) -> List[str]:
    """`c++filt` of each name, its argument list cut off; the names as
    they are where `c++filt` is missing."""
    try:
        res = subprocess.run(["c++filt"], input="\n".join(names),
                             capture_output=True, text=True, check=True)
    except (OSError, subprocess.CalledProcessError):
        return list(names)
    out = res.stdout.splitlines()
    return [d.split("(")[0] for d in out] if len(out) == len(names) \
        else list(names)


def _library(lib_path: Optional[str]) -> Tuple[str, str]:
    """(cuobjdump, library): `lib_path`, or `utils/build.load_kernels()`'s
    library, built first if need be."""
    _, cuobjdump = _toolkit()
    if lib_path is None:
        build.load_kernels()
        lib_path = build.build_info()["path"]
    return cuobjdump, lib_path


def function_names(lib_path: Optional[str] = None) -> List[str]:
    """The mangled names of every kernel in the library (`cuobjdump
    -res-usage`, which reads no code)."""
    cuobjdump, lib_path = _library(lib_path)
    out = subprocess.run([cuobjdump, "-res-usage", lib_path],
                         capture_output=True, text=True, check=True).stdout
    return sorted(set(re.findall(r"Function (\S+):", out)))


def sass_functions(lib_path: Optional[str] = None,
                   names: Optional[List[str]] = None) -> List[dict]:
    """Functions of the kernels' library as `cuobjdump -sass` shows them:
    [{"name": mangled, "kernel": demangled, "sass": its text}]; all of
    them (the disassembly of the whole library takes seconds, so it runs
    once a build), or only the mangled `names` (`cuobjdump -fun`)."""
    cuobjdump, lib_path = _library(lib_path)
    if names is None:
        return _sass_of(cuobjdump, lib_path, os.path.getmtime(lib_path))
    if not names:
        return []
    return _sass_split(subprocess.run(
        [cuobjdump, "-sass", "-fun", ",".join(names), lib_path],
        capture_output=True, text=True, check=True).stdout)


@functools.lru_cache(maxsize=2)
def _sass_of(cuobjdump: str, lib_path: str, mtime: float) -> List[dict]:
    """Every function's SASS of one build of a library (path, mtime)."""
    return _sass_split(subprocess.run(
        [cuobjdump, "-sass", lib_path], capture_output=True, text=True,
        check=True).stdout)


def _sass_split(sass: str) -> List[dict]:
    parts = re.split(r"\n\s+Function : ", sass)[1:]
    names = [p.split("\n", 1)[0].strip() for p in parts]
    return [{"name": n, "kernel": d, "sass": p}
            for n, d, p in zip(names, _demangle(names), parts)]


def _resource_lines(log: str, names: List[str]) -> List[str]:
    """The assembler's report lines of the entries of `names`."""
    out, on = [], False
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            on = _mangled_match(m.group(1), names)
        if on and line.strip():
            out.append(line.rstrip())
    return out


def _sass_dump(funcs: List[dict], log: str, names: List[str]) -> str:
    """The resource lines, then the SASS, of the functions `names`."""
    lines = _resource_lines(log, names)
    return "\n".join(["// -Xptxas -v", *("// " + ln for ln in lines), ""]
                     + [f"\tFunction : {f['name']}\n// {f['kernel']}\n"
                        + f["sass"] for f in funcs
                        if _mangled_match(f["name"], names)])


def dump_lowered(kernel: str, compiled: bool = False,
                 path: Optional[str] = None) -> str:
    """Return (and optionally write) a kernel's code as the card gets it.

    `kernel` names a `csrc/*.cu` source (every kernel in it) or a kernel,
    the name of its `__global__` function (every instantiation).
    `compiled=False` gives the PTX (`nvcc -ptx` with `utils/build.py`'s
    flags, for the virtual sm_90a target); `compiled=True` the SASS of
    its instantiations in the library that `utils/build.load_kernels`
    built (`cuobjdump -sass`), after the assembler's resource lines of
    each (registers, stack frame, spill bytes).  Raises without the CUDA
    toolkit."""
    src, names = _source_of(kernel)
    if compiled:
        funcs = sass_functions(names=[n for n in function_names()
                                      if _mangled_match(n, names)])
        text = _sass_dump(funcs, build.build_info().get("compiler_output", ""),
                          names)
    else:
        text = _ptx_entries(_ptx(src), names)
    if path:
        with open(path, "w") as fh:
            fh.write(text)
    return text


def dump_flagship_kernels(outdir: str = "ir_dump") -> dict:
    """Write the PTX (`<kernel>.ptx`) and SASS (`<kernel>.sass`) of every
    kernel of `KERNELS` into `outdir`, and `resources.json`: each
    instantiation's registers, stack frame, spill bytes and barriers by
    K-number.  Returns that index."""
    _toolkit()
    os.makedirs(outdir, exist_ok=True)
    build.load_kernels(rebuild=True)  # the report of this very build
    log = build.build_info()["compiler_output"]
    regs = ptxas_resources(log)
    funcs = sass_functions()
    srcs = sorted({_source_of(n)[0] for ns in KERNELS.values() for n in ns})
    with ThreadPoolExecutor(len(srcs)) as ex:
        ptx = dict(zip(srcs, ex.map(_ptx, srcs)))
    index: dict = {}
    for label, names in KERNELS.items():
        index[label] = {}
        for name in names:
            src, _ = _source_of(name)
            for tag, text in (
                    ("ptx", _ptx_entries(ptx[src], [name])),
                    ("sass", _sass_dump(funcs, log, [name]))):
                p = os.path.join(outdir, f"{name}.{tag}")
                with open(p, "w") as fh:
                    fh.write(text)
                print(f"wrote {p}", flush=True)
            for f in funcs:
                if _mangled_match(f["name"], [name]):
                    index[label][f["kernel"]] = regs.get(f["name"], {})
    with open(os.path.join(outdir, "resources.json"), "w") as fh:
        json.dump(index, fh, indent=1)
    return index


if __name__ == "__main__":
    dump_flagship_kernels(sys.argv[1] if len(sys.argv) > 1 else "ir_dump")
