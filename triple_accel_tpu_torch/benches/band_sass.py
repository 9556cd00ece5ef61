"""Registers, spills and the hot loop's instructions of the wavefront
kernels and of the headline Myers kernels.

    python3 -m triple_accel_tpu_torch.benches.band_sass [--kernel band
        blocked diag flat myers_distance myers_search trace_walk]

Builds the kernels (`utils/build.py`), reads what `-Xptxas -v` reports for
every instantiation of the kernels named (registers, stack frame and
spill bytes, barriers) and, from `cuobjdump -sass` of the library, its hot loop:
`band` (the default): the row loop of each `band_kernel<TRANS, TRACE, C>`
and `band_block_kernel<TRANS, TRACE, C>`, the code between its one
backward branch and that branch's target;
`blocked` (`blocked_kernel<W, DAMERAU, SEARCH>`, K5 / K6) and `diag`
(`search_diag_kernel<R, TRANS>`, K7): the column loops, every innermost
loop (a backward branch's range holding no other) that shuffles, with the
steps it runs (its shuffles over the shuffles a step: 1 in K6, 5 or 7 in
K7).  Per loop: its instructions (static count, so rarely taken paths
count too), the DPX min instructions, the shuffles, the add-with-carry
instructions (IADD3.X), and every conditional forward branch inside it,
by what the code it skips holds: a store, a load, a shuffle, or none of
these ("arithmetic": a branch in the cells' or words' arithmetic would
show here).  `myers_distance` (`myers_distance_kernel<NW>`, K1) and
`myers_search` (`myers_search_kernel<NW, DAM>`, K2) unroll 16 rows or
columns into straight runs of code with no branch (K1's chunk, masked and
unmasked; K2's chunk up to 4 words, its quad of 4 columns beyond): the two
longest branch-free runs are those bodies, reported with their
instructions a row or column and their shared-memory, global-memory,
add-with-carry, funnel-shift and 3-input-logic instructions; every
innermost loop besides.  `trace_walk` (`trace_walk_kernel`, K10): every
innermost loop (the walker's step loop among them) with those counts,
its branches and convergence barriers (BSSY).  `flat`
(`flat_kernel<SEARCH, TRANS, C>`, K8 with SEARCH, K9 without): the row
loop, the innermost loop that shuffles once the spin loops of its
hand-over waits (loops holding no shuffle) are set aside, with the
instructions of a lane's C columns and a cell, its spin loops and the
`_loop_counts` above.  One JSON line per instantiation (per loop for the
column loops).  The SASS and the compiler's report come from
`utils/inspect_ir.py`.  Needs the CUDA toolkit (`nvcc`, `cuobjdump`); no
device.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import re
import sys

from ..utils import build, inspect_ir

_INSN = re.compile(r"\s+/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z0-9_.]+)"
                   r"([^;]*);")


def _ops(body: str):
    """(address, opcode, branch target or None, predicated) per
    instruction."""
    ops = []
    for line in body.splitlines():
        m = _INSN.match(line)
        if m:
            tgt = re.search(r"0x([0-9a-f]+)", m.group(4))
            ops.append((int(m.group(1), 16), m.group(3),
                        int(tgt.group(1), 16) if tgt else None,
                        m.group(2) is not None))
    return ops


def _loop_counts(ops, lo: int, hi: int) -> dict:
    """The counts of the loop [lo, hi) (hi: its backward branch)."""
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
        "instructions": len(loop),
        "dpx_min": kinds["VIADDMNMX"] + kinds["VIMNMX"] + kinds["VIMNMX3"],
        "shuffles": kinds["SHFL"], "bssy": kinds["BSSY"],
        "add_with_carry": sum(1 for x in loop if x[1].startswith("IADD3.X")),
        "forward_branches": dict(branches),
    }


def _row_loop(body: str) -> dict:
    ops = _ops(body)
    backs = [(tgt, a) for a, op, tgt, _ in ops
             if op.startswith("BRA") and tgt is not None and tgt < a]
    if len(backs) != 1:
        return {"row_loop": f"{len(backs)} backward branches"}
    c = _loop_counts(ops, *backs[0])
    return {"row_loop_instructions": c.pop("instructions"), **c}


def _column_loops(body: str, shuffles_a_step: int) -> list:
    """Every innermost loop that shuffles: its counts, the steps it runs
    and its instructions a step."""
    ops = _ops(body)
    backs = [(tgt, a) for a, op, tgt, _ in ops
             if op.startswith("BRA") and tgt is not None and tgt < a]
    inner = [(lo, hi) for lo, hi in backs
             if not any(lo <= l2 and h2 <= hi and (l2, h2) != (lo, hi)
                        for l2, h2 in backs)]
    out = []
    for lo, hi in sorted(inner):
        c = _loop_counts(ops, lo, hi)
        if c["shuffles"] == 0:
            continue
        steps = c["shuffles"] // shuffles_a_step
        out.append({"steps": steps, **c,
                    "instructions_a_step": round(c["instructions"]
                                                 / max(steps, 1), 1)})
    return out


def _row_loops(body: str, cols: int) -> list:
    """The loops that shuffle and hold no smaller loop that shuffles (the
    spin loops inside them hold no shuffle): their counts, the spin loops
    inside, and the instructions of a lane's `cols` columns a cell."""
    ops = _ops(body)
    backs = [(tgt, a) for a, op, tgt, _ in ops
             if op.startswith("BRA") and tgt is not None and tgt < a]

    def shuffles(lo, hi):
        return any(lo <= x[0] < hi and x[1].startswith("SHFL") for x in ops)

    holders = [(lo, hi) for lo, hi in backs if shuffles(lo, hi)]
    out = []
    for lo, hi in sorted(holders):
        if any(lo <= l2 and h2 <= hi and (l2, h2) != (lo, hi)
               for l2, h2 in holders):
            continue
        c = _loop_counts(ops, lo, hi)
        spins = sum(1 for l2, h2 in backs
                    if lo <= l2 and h2 < hi and (l2, h2) != (lo, hi))
        out.append({"at": hex(lo), **c, "spin_loops": spins,
                    "instructions_a_cell": round(c["instructions"] / cols,
                                                 1)})
    return out


def _op_kinds(run) -> dict:
    kinds = collections.Counter(x[1].split(".")[0] for x in run)
    return {
        "instructions": len(run),
        "shared_loads": kinds["LDS"], "shared_stores": kinds["STS"],
        "global_loads": kinds["LDG"], "global_stores": kinds["STG"],
        "add_with_carry": sum(1 for x in run if x[1].startswith("IADD3.X")),
        "funnel_shifts": sum(1 for x in run if x[1].startswith("SHF")
                             and ".W" in x[1]),
        "logic_3_input": kinds["LOP3"],
    }


def _inner_loops(body: str) -> list:
    """Every innermost loop (a backward branch's range holding no other):
    its instructions and memory operations (`_op_kinds`) and branches."""
    ops = _ops(body)
    backs = [(tgt, a) for a, op, tgt, _ in ops
             if op.startswith("BRA") and tgt is not None and tgt < a]
    out = []
    for lo, hi in sorted(backs):
        if any(lo <= l2 and h2 <= hi and (l2, h2) != (lo, hi)
               for l2, h2 in backs):
            continue
        loop = [x for x in ops if lo <= x[0] <= hi]
        out.append({"at": hex(lo), **_op_kinds(loop),
                    "branches": sum(x[1].startswith("BRA") for x in loop),
                    "convergence_barriers": sum(x[1].startswith("BSSY")
                                                for x in loop)})
    return out


def _straight_bodies(body: str, steps_of, keep: int = 2) -> dict:
    """The `keep` longest runs of code with no branch in or out: the fully
    unrolled row / column bodies (a kernel may hold a guarded and an
    unguarded one).  `steps_of(counts)`: the rows or columns a run holds.
    Every innermost loop besides."""
    ops = _ops(body)
    targets = {t for _, op, t, _ in ops if op.startswith("BRA") and t}
    runs, cur = [], []
    for x in ops:
        if x[0] in targets and cur:
            runs.append(cur)
            cur = []
        cur.append(x)
        if x[1].startswith(("BRA", "EXIT", "RET", "BSYNC", "WARPSYNC",
                            "BAR", "CALL")):
            runs.append(cur)
            cur = []
    runs.append(cur)
    bodies = []
    for run in sorted(runs, key=len, reverse=True)[:keep]:
        c = _op_kinds(run)
        steps = steps_of(c)
        bodies.append({"at": hex(run[0][0]), "steps": steps, **c,
                       **{f"{k}_a_step": round(v / steps, 2)
                          for k, v in c.items()}})
    backs = [(tgt, a) for a, op, tgt, _ in ops
             if op.startswith("BRA") and tgt is not None and tgt < a]
    inner = [(lo, hi) for lo, hi in backs
             if not any(lo <= l2 and h2 <= hi and (l2, h2) != (lo, hi)
                        for l2, h2 in backs)]
    return {"bodies": bodies,
            "innermost_loops": [_loop_counts(ops, lo, hi)
                                for lo, hi in sorted(inner)]}


# the kernel each --kernel choice names (its mangled names hold it)
_KERNELS = {"band": "band_kernel", "blocked": "blocked_kernel",
            "diag": "search_diag_kernel", "flat": "flat_kernel",
            "myers_distance": "myers_distance_kernel",
            "myers_search": "myers_search_kernel",
            "trace_walk": "trace_walk_kernel"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", nargs="+", default=["band"],
                    choices=sorted(_KERNELS))
    ap.add_argument("--dump", metavar="DIR",
                    help="also write each instantiation's SASS and the "
                         "compiler's report there")
    args = ap.parse_args(argv)
    build.load_kernels(rebuild=True)
    info = build.build_info()
    regs = inspect_ir.ptxas_resources(info["compiler_output"])
    if args.dump:
        os.makedirs(args.dump, exist_ok=True)
        with open(os.path.join(args.dump, "ptxas.txt"), "w") as fh:
            fh.write(info["compiler_output"])
    for fn in inspect_ir.sass_functions(info["path"]):
        name, demangled, part = fn["name"], fn["kernel"], fn["sass"]
        for kind in args.kernel:
            if kind == "band":
                if not any(k_ in name for k_ in (
                        "band_kernel", "band_block_kernel")):
                    continue
                rec = {"kernel": demangled, **regs.get(name, {}),
                       **_row_loop(part)}
            elif kind in ("myers_distance", "myers_search") \
                    and _KERNELS[kind] in name:
                # K1: a chunk is 16 rows; K2: one table load a word and
                # column, so a run's columns are its shared loads / words
                words = int(re.search(r"<(\d+)", demangled).group(1))
                if kind == "myers_distance":
                    steps_of = (lambda c: 16)
                else:
                    steps_of = (lambda c, w=words: max(
                        round(c["shared_loads"] / w), 1))
                rec = {"kernel": demangled, **regs.get(name, {}),
                       **_straight_bodies(part, steps_of)}
            elif kind == "flat" and _KERNELS[kind] in name:
                cols = int(re.search(r"(\d+)>$", demangled).group(1))
                rec = {"kernel": demangled, **regs.get(name, {}),
                       "row_loops": _row_loops(part, cols)}
            elif kind == "trace_walk" and _KERNELS[kind] in name:
                rec = {"kernel": demangled, **regs.get(name, {}),
                       "innermost_loops": _inner_loops(part)}
            elif _KERNELS[kind] in name:
                per_step = 1  # K6: one word handed up a step
                if kind == "diag":  # <R, TRANS>: 7 shuffles with TRANS
                    per_step = 7 if demangled.rstrip(">").endswith("true") \
                        else 5
                rec = {"kernel": demangled, **regs.get(name, {}),
                       "column_loops": _column_loops(part, per_step)}
            else:
                continue
            if args.dump:
                fname = re.sub(r"[^A-Za-z0-9_]+", "_", demangled).strip("_")
                with open(os.path.join(args.dump, fname + ".sass"), "w") as fh:
                    fh.write(part)
            print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
