"""`correct` can come out false: the control (the reference with one of
the configuration's guarantees broken), put in the program's place and
driven through the harness's own run, is not correct; nor is a run with
the timed path broken underneath."""

import numpy as np
import pytest
import torch

from portbench.harness import run_cell
from portbench.tests.tiny import CELLS, tiny_cell

torch.set_num_threads(1)


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    cell = tiny_cell(name)
    if cell.mix["kind"] == "pairs":
        # long enough that the optimal path strays past the control's
        # band; every pair compared
        cell.config["pair_bytes"] = 4000
        cell.mix["k"] = max(cell.mix["k"], 10_000)
        cell.mix["reference_sample"] = 16
    differs = 0
    for seed in (1, 2, 3):
        r = run_cell(cell, seed, 0.2, False, device="cpu", control=True,
                     emit=lambda s: None)
        assert r["correct"] is False, seed
        assert r["checks"]["failed_calls"]["value"] == 0
        differs += r["checks"]["mismatched_answers"]["value"]
    assert differs >= 3


def _alter_one(call):
    def wrapped(batch):
        out = call(batch)
        if isinstance(out, np.ndarray):
            out = out.copy()
            out[len(out) // 2:] += 1
            return out
        out = [list(r) for r in out]
        for r in out[len(out) // 2:]:
            if r:
                m = r[0]
                r[0] = type(m)(start=m.start + 1, end=m.end, k=m.k)
        return out
    return wrapped


def _half_left_out(call):
    def wrapped(batch):
        half = ((batch[0][: len(batch[0]) // 2], batch[1][: len(batch[1])
                 // 2]) if isinstance(batch, tuple) else batch[: len(batch)
                                                               // 2])
        return call(half)
    return wrapped


def _raises(call):
    def wrapped(batch):
        raise RuntimeError("a launch failed")
    return wrapped


@pytest.mark.parametrize("fault", [_alter_one, _half_left_out, _raises])
@pytest.mark.parametrize("name", CELLS)
def test_broken_timed_path_is_not_correct(name, fault):
    # the warm call in set-up must pass for the run to reach its window
    calls = {"n": 0}

    def wrap(call):
        broken = fault(call)

        def first_sound(batch):
            calls["n"] += 1
            return call(batch) if calls["n"] == 1 else broken(batch)
        return first_sound

    r = run_cell(tiny_cell(name), 11, 0.3, False, device="cpu",
                 wrap=wrap, emit=lambda s: None)
    assert r["correct"] is False
    c = r["checks"]
    assert c["mismatched_answers"]["value"] > 0 or c["failed_calls"][
        "value"] > 0
