"""Needles searched in one resident reference: set-up packs the reference
onto the device once (`PackedHaystack`), and a call is one
`levenshtein_search_many` of a batch of needles at the mix's `k` and
`search_type`, under the configuration's costs that the mix's `costs`
names.

An answer is a needle's Match list as (start, end, cost).  Work: needles
x reference bytes.  Least time: the frozen cost model's `search_bound`.
The control is the plain reference with Best's filter left out: every
match within k, where Best keeps the crate's streaming minimum.
"""

from __future__ import annotations

from portbench import traffic
from portbench.metrics import cost_model
from portbench.reference.search import search_matches


def _costs(cell) -> dict:
    return cell.config["costs"][cell.mix["costs"]]


def make_inputs(cell, seed: int):
    return traffic.scan(cell.config, cell.mix, seed)


def answers_per_call(inputs) -> int:
    return len(inputs.batches[0])


def open_program(cell, inputs, device):
    import triple_accel_tpu_torch as ta

    packed = ta.PackedHaystack(inputs.haystack, device=device)
    packed.device_haystack()
    costs = ta.EditCosts(**_costs(cell))
    k = int(cell.mix["k"])
    search_type = ta.SearchType[cell.mix["search_type"]]

    def call(needles):
        return ta.levenshtein_search_many(needles, packed, k, search_type,
                                          costs, device=device)
    return call


def _answers(cell, inputs, needles, device, best: bool):
    return search_matches(needles, inputs.haystack, int(cell.mix["k"]),
                          _costs(cell), best, device=device)


def open_control(cell, inputs, device, sampled):
    index = {id(x): b for b, x in enumerate(inputs.batches)}

    def call(needles):
        idx = list(sampled.get(index[id(needles)], ()))
        out = [[] for _ in needles]
        for i, r in zip(idx, _answers(cell, inputs, [needles[i] for i in idx],
                                      device, best=False)):
            out[i] = r
        return out
    return call


def _triple(m) -> tuple:
    return (m.start, m.end, m.k) if hasattr(m, "start") else tuple(m)


def keep(out, indices):
    """A call's Match lists at the check's indices, as (start, end, cost)."""
    return len(out), {i: [_triple(m) for m in out[i]]
                      for i in indices if i < len(out)}


def work(cell, inputs, b: int, kept) -> dict:
    return {"needle_bytes_scanned": len(inputs.batches[b])
            * len(inputs.haystack)}


def bound(cell, inputs, b: int, kept) -> dict:
    costs = _costs(cell)
    unit = (costs["mismatch_cost"], costs["gap_cost"],
            costs["start_gap_cost"]) == (1, 1, 0)
    return cost_model.search_bound(len(inputs.haystack),
                                   [len(nd) for nd in inputs.batches[b]],
                                   costs, unit)


def expected(cell, inputs, sample, device) -> dict:
    best = cell.mix["search_type"] == "Best"
    res = _answers(cell, inputs, [inputs.batches[b][i] for b, i in sample],
                   device, best)
    return {s: [tuple(m) for m in r] for s, r in zip(sample, res)}
