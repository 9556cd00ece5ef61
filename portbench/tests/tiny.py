"""Tiny sizes of every cell, for the CPU tests: the same files and code
paths at sizes the program's plain versions finish in seconds."""

from portbench.harness import find_cell

CONFIG = {"wfa10k": {"pair_bytes": 300}, "acgt47m": {"haystack_bytes": 30_000}}
MIX = {
    "exact": {"pairs_per_call": 8, "batches": 2, "reference_sample": 6},
    "banded": {"pairs_per_call": 8, "batches": 2, "reference_sample": 8,
               "k": 94},
    "longread": {"needle_bytes": [300, 300], "k": 40, "batches": 2,
                 "reference_sample": 4},
    "primers": {"needles_per_call": 20, "batches": 2, "reference_sample": 8},
}
CELLS = ("wfa10k.exact", "acgt47m.longread", "acgt47m.primers",
         "wfa10k.banded")


def tiny_cell(name: str, root=None):
    cell = find_cell(name) if root is None else find_cell(name, root)
    cell.config.update(CONFIG.get(cell.workload["config"], {}))
    cell.mix.update(MIX.get(cell.workload["traffic"], {}))
    return cell
