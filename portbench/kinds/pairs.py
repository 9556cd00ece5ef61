"""Distance pairs: a call is one `levenshtein_k_batch` over a batch of
(a, b) pairs at the mix's threshold `k`, under the configuration's costs
that the mix's `costs` names.

An answer is a pair's distance, or -1 above the pair's capped threshold
(the crate's `levenshtein_simd_k`).  Work: pairs.  Least time: the frozen
cost model's `pairs_bound`.  The control is the plain reference held to a
fixed band of `CONTROL_BAND` diagonals, an adaptive-band shortcut that is
no longer exact.
"""

from __future__ import annotations

import numpy as np

from portbench import traffic
from portbench.metrics import cost_model
from portbench.reference.distance import gap_affine_distances

CONTROL_BAND = 8


def _costs(cell) -> dict:
    return cell.config["costs"][cell.mix["costs"]]


def make_inputs(cell, seed: int):
    return traffic.pairs(cell.config, cell.mix, seed)


def answers_per_call(inputs) -> int:
    return len(inputs.batches[0][0])


def open_program(cell, inputs, device):
    import triple_accel_tpu_torch as ta

    costs = ta.EditCosts(**_costs(cell))
    k = int(cell.mix["k"])

    def call(batch):
        return ta.levenshtein_k_batch(batch[0], batch[1], k, costs,
                                      device=device)
    return call


def _answers(cell, a, b, device, band=None) -> np.ndarray:
    costs = _costs(cell)
    d = gap_affine_distances(a, b, costs, device=device, band=band)
    cap = cost_model.max_k([len(x) for x in a], [len(x) for x in b],
                           int(cell.mix["k"]), costs)
    return np.where(d <= cap, d, -1)


def open_control(cell, inputs, device, sampled):
    index = {id(x): b for b, x in enumerate(inputs.batches)}

    def call(batch):
        idx = list(sampled.get(index[id(batch)], ()))
        out = np.zeros(len(batch[0]), np.int64)
        if idx:
            out[idx] = _answers(cell, [batch[0][i] for i in idx],
                                [batch[1][i] for i in idx], device,
                                band=CONTROL_BAND)
        return out
    return call


def keep(out, indices):
    """All of a call's distances: the roofline reads them."""
    return len(out), np.asarray(out)


def work(cell, inputs, b: int, kept) -> dict:
    return {"pairs": len(inputs.batches[b][0])}


def bound(cell, inputs, b: int, kept) -> dict:
    a, bb = inputs.batches[b]
    return cost_model.pairs_bound([len(x) for x in a], [len(x) for x in bb],
                                  int(cell.mix["k"]), _costs(cell),
                                  dists=kept[1])


def expected(cell, inputs, sample, device) -> dict:
    a = [inputs.batches[b][0][i] for b, i in sample]
    bb = [inputs.batches[b][1][i] for b, i in sample]
    return {s: int(v) for s, v in
            zip(sample, _answers(cell, a, bb, device).tolist())}
