"""What decides `correct`: the answers the timed calls returned, held
against the plain reference on a sample drawn from the seed.

The cell's kind (`kinds/<kind>.py`) says what an answer is and what the
reference answers: distance cells the distance of each sampled pair, or
-1 above the pair's capped threshold, as the crate's `levenshtein_simd_k`
gives it; scan cells each sampled needle's Match list (start, end, cost)
in order.  Every completed call that carried a sampled pair or needle is
compared; the comparison is exact, so its limit is 0.

The control puts the reference in the program's place with one of the
configuration's guarantees broken (the kind's `open_control`); run
through the harness, it has to come out not correct.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

__all__ = ["draw_sample", "count_mismatches"]


def draw_sample(inputs, per_call: int, want: int,
                seed: int) -> List[Tuple[int, int]]:
    """(batch, index) of the answers compared: `want` of them drawn from
    the seed (all when there are no more), a quarter from the inputs'
    `planted` indices where it has any."""
    rng = np.random.default_rng([int(seed), 7])
    n_batch = len(inputs.batches)
    every = [(b, i) for b in range(n_batch) for i in range(per_call)]
    if want >= len(every):
        return every
    planted = [(b, i) for b in range(n_batch)
               for i in (getattr(inputs, "planted", None)
                         or [[]] * n_batch)[b]]
    n_pl = min(len(planted), want // 4)
    pick = set()
    if n_pl:
        for j in rng.choice(len(planted), n_pl, replace=False).tolist():
            pick.add(planted[j])
    rest = [x for x in every if x not in pick]
    for j in rng.choice(len(rest), want - len(pick), replace=False).tolist():
        pick.add(rest[j])
    return sorted(pick)


def count_mismatches(kept, expected: dict,
                     per_call: int) -> Tuple[int, int]:
    """(answers compared, answers that differ) over every call (`kept`:
    (batch, the kind's `keep` record) a call); a call that failed, or
    returned another number of answers, differs at every sampled index."""
    by_batch: Dict[int, List[int]] = {}
    for b, i in expected:
        by_batch.setdefault(b, []).append(i)
    compared = mismatched = 0
    for b, rec in kept:
        for i in by_batch.get(b, ()):
            compared += 1
            if rec is None or rec[0] != per_call:
                mismatched += 1
            elif rec[1][i] != expected[(b, i)]:
                mismatched += 1
    return compared, mismatched
