"""Registers, spills and the row loop's instructions of the band kernels.

    python3 -m triple_accel_tpu_torch.benches.band_sass

Builds the kernels (`utils/build.py`), reads what `-Xptxas -v` reports for
every band kernel instantiation (registers, spill bytes, barriers) and,
from `cuobjdump -sass` of the library, the row loop of each
`band_kernel<TRANS, TRACE, C>`: the code between its one backward branch
and that branch's target.  Per loop: its instructions (static count, so
rarely taken paths count too), the DPX min instructions, the shuffles, and
every conditional forward branch inside it, by what the code it skips
holds: a store, a load, a shuffle, or none of these ("arithmetic": a
branch in the cells' passes would show here).  One JSON line per
instantiation.  Needs the CUDA toolkit (`nvcc`, `cuobjdump`); no device.
"""

from __future__ import annotations

import collections
import json
import os
import re
import subprocess
import sys

from ..utils import build

_INSN = re.compile(r"\s+/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z0-9_.]+)"
                   r"([^;]*);")


def _ptxas(log: str) -> dict:
    """Mangled entry name -> registers, spill bytes, barriers."""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = m.group(1)
            out[cur] = {}
        elif cur and "spill stores" in line:
            nums = [int(x) for x in re.findall(r"(\d+) bytes", line)]
            out[cur]["spill_store_bytes"] = nums[1]
            out[cur]["spill_load_bytes"] = nums[2]
        elif cur and "Used" in line and "registers" in line:
            out[cur]["registers"] = int(
                re.search(r"Used (\d+) registers", line).group(1))
            bar = re.search(r"used (\d+) barriers", line)
            out[cur]["barriers"] = int(bar.group(1)) if bar else 0
    return out


def _row_loop(body: str) -> dict:
    ops = []
    for line in body.splitlines():
        m = _INSN.match(line)
        if m:
            tgt = re.search(r"0x([0-9a-f]+)", m.group(4))
            ops.append((int(m.group(1), 16), m.group(3),
                        int(tgt.group(1), 16) if tgt else None,
                        m.group(2) is not None))
    backs = [(tgt, a) for a, op, tgt, _ in ops
             if op.startswith("BRA") and tgt is not None and tgt < a]
    if len(backs) != 1:
        return {"row_loop": f"{len(backs)} backward branches"}
    lo, hi = backs[0]
    loop = [x for x in ops if lo <= x[0] < hi]
    kinds = collections.Counter(x[1].split(".")[0] for x in loop)
    branches = collections.Counter()
    for a, op, tgt, cond in loop:
        if not (op.startswith("BRA") and cond) or tgt is None or tgt <= a:
            continue
        skipped = {x[1].split(".")[0] for x in loop if a < x[0] < tgt}
        kind = ("store" if "STG" in skipped else "load" if "LDG" in skipped
                else "shuffle" if "SHFL" in skipped else "arithmetic")
        branches[kind] += 1
    return {
        "row_loop_instructions": len(loop),
        "dpx_min": kinds["VIADDMNMX"] + kinds["VIMNMX"] + kinds["VIMNMX3"],
        "shuffles": kinds["SHFL"], "bssy": kinds["BSSY"],
        "forward_branches": dict(branches),
    }


def main() -> int:
    build.load_kernels(rebuild=True)
    info = build.build_info()
    regs = _ptxas(info["compiler_output"])
    tool = os.path.join(os.path.dirname(build.find_nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", info["path"]], capture_output=True,
                          text=True, check=True).stdout
    for part in re.split(r"\n\s+Function : ", sass)[1:]:
        name = part.split("\n", 1)[0].strip()
        if "band_kernel" not in name and "band_wide_kernel" not in name:
            continue
        demangled = subprocess.run(["c++filt", name], capture_output=True,
                                   text=True).stdout.strip().split("(")[0]
        rec = {"kernel": demangled, **regs.get(name, {})}
        if "band_kernel" in name and "wide" not in name:
            rec.update(_row_loop(part))
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
