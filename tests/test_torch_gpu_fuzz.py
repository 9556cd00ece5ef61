"""`benches/gpu_fuzz.py` on the CPU, at a cut.

The fuzz runs at full size on the card (`chip_smoke.py`'s `fuzz` phase);
here its short-string sections run on the plain versions and must pass
and reach the engines they name, a planted wrong distance must be
counted, and the native search that judges its long sections must equal
the scalar oracle.
"""

import json

import numpy as np
import torch

from triple_accel_tpu_torch.benches import gpu_fuzz
from triple_accel_tpu_torch.oracle import levenshtein_search_naive_with_opts
from triple_accel_tpu_torch.types import (
    EditCosts,
    LEVENSHTEIN_COSTS,
    RDAMERAU_COSTS,
    SearchType,
)
from triple_accel_tpu_torch.utils.native import native_available

# one intra-op thread: the test workers run side by side on the
# machine's cores
torch.set_num_threads(1)

SHORT = ["1", "2", "3", "4", "5"]


def _lines(out: str):
    return [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]


def test_short_sections_pass_and_reach_their_engines(capsys):
    rc = gpu_fuzz.main(["--device", "cpu", "--sections", *SHORT,
                        "--scale", "0.3"])
    lines = _lines(capsys.readouterr().out)
    sections = [ln for ln in lines if "section" in ln]
    assert rc == 0
    assert [ln["section"] for ln in sections] == [int(s) for s in SHORT]
    for ln in sections:
        assert ln["mismatches"] == 0 and ln["cases"] > 0
        assert gpu_fuzz.SECTIONS[ln["section"]][2] <= set(ln["engines"])
    assert lines[-1]["mismatches"] == 0 and lines[-1]["device"] == "cpu"


def test_a_planted_wrong_distance_is_one_mismatch(monkeypatch, capsys):
    real = gpu_fuzz.levenshtein_k_batch
    calls = []

    def off_by_one(*args, **kw):
        out = real(*args, **kw)
        if not calls:
            out = out.copy()
            out[3] += 1
        calls.append(1)
        return out

    monkeypatch.setattr(gpu_fuzz, "levenshtein_k_batch", off_by_one)
    rc = gpu_fuzz.main(["--device", "cpu", "--sections", "1",
                        "--scale", "0.3"])
    out = capsys.readouterr().out
    (section,) = [ln for ln in _lines(out) if "section" in ln]
    assert rc == 1 and len(calls) > 1
    assert section["mismatches"] == 1
    assert out.count("MISMATCH DIST t0") == 1
    assert out.rstrip().endswith("FINAL FUZZ TOTAL: 1 mismatches")


def test_native_search_equals_the_oracle():
    assert native_available()
    rng = np.random.default_rng(7)
    for trial in range(24):
        costs = [LEVENSHTEIN_COSTS, RDAMERAU_COSTS, EditCosts(2, 1, 1, None),
                 EditCosts(3, 2, 1, 2)][trial % 4]
        m = int(rng.integers(1, 12))
        needle = rng.integers(65, 69, m).astype(np.uint8)
        hay = rng.integers(65, 69, int(rng.integers(0, 200))).astype(
            np.uint8)
        k = int(rng.integers(0, 2 * m + 2))  # k >= m reaches the end-0 match
        for st in (SearchType.Best, SearchType.All):
            for anchored in (False, True):
                exp = levenshtein_search_naive_with_opts(needle, hay, k, st,
                                                         costs, anchored)
                got = gpu_fuzz.native_search(needle, hay, k, st, costs,
                                             anchored)
                assert got == exp, (trial, st, anchored)
