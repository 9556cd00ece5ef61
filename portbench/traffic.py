"""The benchmark's one general generator: inputs of every cell from its
configuration file, its traffic mix file and `--seed`.

Frozen copies of the generators the port's smoke run used on the card
(`substitute_acgt`, `edit_acgt`, the long-pair and dictionary inputs), so
that a change to the program cannot move the inputs.  A kind of traffic
(`kinds/<kind>.py`) builds its inputs from these; the ones so far:

* `pairs`: batches of (a, b) pairs: `a` random ACGT of the configuration's
  length, `b` a copy with its share of edits in equal parts substitution,
  insertion and deletion;
* `scan`: one random ACGT reference of the configuration's length and
  batches of needles cut from it at random loci, each with its share of
  edits, some (the mix's `planted`, default none) planted back as copies
  with substitutions.

Every seed gives the same sizes and counts (lengths, edit counts, copies);
the seed only moves loci, letters and edit positions.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

import numpy as np

__all__ = [
    "ACGT",
    "substitute_acgt",
    "edit_acgt",
    "random_acgt",
    "PairsInput",
    "ScanInput",
    "pairs",
    "scan",
]

ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)
_ACGT_INDEX = np.zeros(256, dtype=np.uint8)
_ACGT_INDEX[ACGT] = np.arange(4, dtype=np.uint8)


def substitute_acgt(seq: np.ndarray, pos: np.ndarray, rng) -> None:
    """Overwrite the ACGT letters at `pos` with another ACGT letter each,
    in place."""
    seq[pos] = ACGT[(_ACGT_INDEX[seq[pos]]
                     + rng.integers(1, 4, len(pos)).astype(np.uint8)) % 4]


def edit_acgt(a: np.ndarray, n_edits: int, rng) -> np.ndarray:
    """A copy of the ACGT string `a` with `n_edits` edits in equal shares:
    n_edits // 3 insertions, as many deletions, the rest substitutions (to
    another letter), at random positions."""
    n_ins = n_del = n_edits // 3
    n_sub = n_edits - n_ins - n_del
    b = a.copy()
    substitute_acgt(b, rng.choice(len(b), n_sub, replace=False), rng)
    b = np.delete(b, rng.choice(len(b), n_del, replace=False))
    return np.insert(b, rng.integers(0, len(b) + 1, n_ins),
                     ACGT[rng.integers(0, 4, n_ins)])


def random_acgt(rng, shape) -> np.ndarray:
    return ACGT[rng.integers(0, 4, shape, dtype=np.uint8)]


@dataclass
class PairsInput:
    """`batches[c]` = (a list, b list) of one call's pairs; calls take the
    batches in turn."""
    batches: List[tuple]


@dataclass
class ScanInput:
    """The reference and `batches[c]`, one call's needles; `planted[c]`:
    the indices of batch c's needles planted as copies."""
    haystack: np.ndarray
    batches: List[List[np.ndarray]]
    planted: List[List[int]] = field(default_factory=list)


def pairs(cfg: dict, mix: dict, seed: int) -> PairsInput:
    """`mix["batches"]` batches of `mix["pairs_per_call"]` pairs from
    `seed` alone."""
    rng = np.random.default_rng(int(seed))
    length = int(cfg["pair_bytes"])
    n_edits = int(round(length * float(cfg["edit_share"])))
    batches = []
    for _ in range(int(mix["batches"])):
        a_rows = random_acgt(rng, (int(mix["pairs_per_call"]), length))
        batches.append((list(a_rows),
                        [edit_acgt(a, n_edits, rng) for a in a_rows]))
    return PairsInput(batches)


def _needle_lengths(mix: dict, rng) -> np.ndarray:
    """The lengths of one call's needles: every length of the mix's range
    in turn (the same multiset for every seed), in a seeded order."""
    lo, hi = mix["needle_bytes"]
    lens = lo + np.arange(int(mix["needles_per_call"])) % (hi - lo + 1)
    return rng.permutation(lens)


def scan(cfg: dict, mix: dict, seed: int) -> ScanInput:
    """The reference and `mix["batches"]` batches of needles from `seed`
    alone."""
    rng = np.random.default_rng(int(seed))
    n = int(cfg["haystack_bytes"])
    hay = random_acgt(rng, n)
    share = float(mix.get("edit_share", 0.0))
    batches, planted = [], []
    for _ in range(int(mix["batches"])):
        needles = []
        for m in _needle_lengths(mix, rng).tolist():
            pos = int(rng.integers(0, n - m + 1))
            nd = hay[pos: pos + m].copy()
            n_edits = int(round(m * share))
            needles.append(edit_acgt(nd, n_edits, rng) if n_edits else nd)
        batches.append(needles)
        planted.append(sorted(rng.choice(
            len(needles), int(mix.get("planted", 0)), replace=False).tolist()))
    copies = int(mix.get("copies", 0))
    slot = int(mix.get("copy_slot_bytes", 512))
    n_copies = sum(len(p) for p in planted) * copies
    if n_copies:
        # each copy in a slot of its own, 16 bytes into the slot; a copy
        # carries 1 substitution, the next 2, and so on (1 + c % 2)
        subs = mix["copy_substitutions"]
        slots = rng.choice(n // slot - 1, n_copies, replace=False)
        s = 0
        for needles, idx in zip(batches, planted):
            for i in idx:
                for c in range(copies):
                    copy = needles[i].copy()
                    n_sub = subs[c % len(subs)]
                    substitute_acgt(copy, rng.choice(len(copy), n_sub,
                                                     replace=False), rng)
                    p0 = int(slots[s]) * slot + 16
                    hay[p0: p0 + len(copy)] = copy
                    s += 1
    return ScanInput(hay, batches, planted)

