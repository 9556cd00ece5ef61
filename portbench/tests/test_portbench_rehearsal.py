"""A rehearsal of every cell on the CPU at tiny sizes: the generator, the
driven entry point, the reference, the check and the metric arithmetic;
the real command without a card; a cell added by files alone; the names
and units of BENCHMARK.json; cells of a new kind of traffic and a new
metric added by files alone."""

import json
import os
import re
import shutil
import subprocess
import sys

import pytest
import torch

from portbench.harness import ROOT, find_cell, run_cell
from portbench.tests.tiny import CELLS, tiny_cell

torch.set_num_threads(1)
SEED = 2**31 + 12345  # past 32 signed bits, as a run's seed may be


def _quiet(_line):
    pass


@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_correct_on_the_cpu(name):
    r = run_cell(tiny_cell(name), SEED, 0.5, False, device="cpu",
                 emit=_quiet)
    assert r["correct"] and r["attempted"] >= 1 and r["failed"] == 0
    assert set(r["metrics"]) == {m["name"] for m in
                                 find_cell(name).end_to_end}
    assert all(v["value"] > 0 for v in r["metrics"].values())
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("name", ["wfa10k.exact", "acgt47m.primers"])
def test_traced_run_on_the_cpu(name):
    r = run_cell(tiny_cell(name), SEED + 1, 0.3, True, device="cpu",
                 emit=_quiet)
    assert r["correct"]
    assert r["device"]["window_s"] > 0
    # no device operations on the CPU: only the idle share is readable,
    # and no roofline share is made up
    assert not any("roofline" in k for k in r["metrics"])
    idle = [m["name"] for m in find_cell(name).per_layer
            if m["name"].startswith("idle_pct.")]
    assert idle and set(idle) <= set(r["metrics"])


def test_same_seed_same_inputs():
    cell = tiny_cell("acgt47m.primers")
    x = cell.kind.make_inputs(cell, SEED)
    y = cell.kind.make_inputs(cell, SEED)
    assert (x.haystack == y.haystack).all()
    assert all((a == b).all() for a, b in zip(x.batches[1], y.batches[1]))
    z = cell.kind.make_inputs(cell, SEED + 1)
    assert sorted(map(len, z.batches[0])) == sorted(map(len, x.batches[0]))


def test_the_filter_answers_both_ways():
    # the threshold filter's cell compares -1 answers as well as distances
    cell = tiny_cell("wfa10k.banded")
    inputs = cell.kind.make_inputs(cell, SEED)
    sample = [(b, i) for b in range(len(inputs.batches))
              for i in range(cell.kind.answers_per_call(inputs))]
    got = list(cell.kind.expected(cell, inputs, sample, "cpu").values())
    assert -1 in got and max(got) > 0


def test_command_without_a_card_exits_nonzero():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "wfa10k.exact",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=120, env=env)
    assert p.returncode != 0
    assert '"correct"' not in p.stdout
    assert "no result" in p.stderr


def _checkout(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "portbench"), root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    return root


def _files(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            if "__pycache__" not in d:
                p = os.path.join(d, n)
                out[os.path.relpath(p, root)] = open(p, "rb").read()
    return out


def _add_entries(root, config, workload, metric, e2e_cells):
    """Append entries to the copy's BENCHMARK.json, as a later change
    would: nothing in it is rewritten."""
    path = root / "BENCHMARK.json"
    spec = json.loads(path.read_text())
    spec["configs"].append(config)
    spec["workloads"].append(workload)
    spec["per_layer"].append(metric)
    for m in spec["end_to_end"]:
        if m["name"] in e2e_cells:
            m["workloads"].append(workload["name"])
    path.write_text(json.dumps(spec))


def test_a_cell_added_by_files_alone(tmp_path):
    root = _checkout(tmp_path)
    before = _files(root / "portbench")
    (root / "portbench" / "configs" / "pairs2k.json").write_text(json.dumps(
        {"pair_bytes": 120, "edit_share": 0.1, "costs": {"affine": {
            "mismatch_cost": 3, "gap_cost": 1, "start_gap_cost": 2,
            "transpose_cost": None}}}))
    (root / "portbench" / "mixes" / "few.json").write_text(json.dumps(
        {"kind": "pairs", "costs": "affine", "k": 30, "pairs_per_call": 5,
         "batches": 2, "reference_sample": 4}))
    (root / "portbench" / "metrics" / "answers_per_call.pairs.py") \
        .write_text("def read(ctx):\n    return float(len(ctx['calls']))\n")
    _add_entries(
        root, {"name": "pairs2k", "source": "x",
               "file": "portbench/configs/pairs2k.json", "reduced": [],
               "why": "x"},
        {"name": "pairs2k.few", "config": "pairs2k", "traffic": "few",
         "chips": 1, "why": "x"},
        {"name": "answers_per_call.pairs", "unit": "calls",
         "better": "higher", "source": "program_counter", "layer": "x",
         "moves": "pairs_per_s", "workloads": ["pairs2k.few"]},
        ("pairs_per_s", "batch_ms_p95"))
    cell = find_cell("pairs2k.few", str(root))
    assert [m["name"] for m in cell.per_layer] == ["answers_per_call.pairs"]
    r = run_cell(cell, 7, 0.3, True, device="cpu", emit=_quiet)
    assert r["correct"]
    assert r["metrics"]["answers_per_call.pairs"]["value"] == r["attempted"]
    r = run_cell(cell, 7, 0.3, False, device="cpu", emit=_quiet)
    assert set(r["metrics"]) == {"pairs_per_s", "batch_ms_p95", "setup_s"}
    after = _files(root / "portbench")
    assert all(after[p] == v for p, v in before.items())


# A kind of traffic the benchmark does not have: Hamming distances of
# equal-length rows through another entry point, with its own plain
# reference, work and bound, and a metric that reads the run's record.
HAMMING_KIND = """
import numpy as np

from portbench.metrics import cost_model


class Inputs:
    def __init__(self, batches):
        self.batches = batches


def make_inputs(cell, seed):
    rng = np.random.default_rng(int(seed))
    n, m = cell.mix["rows_per_call"], cell.config["row_bytes"]
    return Inputs([tuple(rng.integers(65, 69, (2, n, m), dtype=np.uint8))
                   for _ in range(cell.mix["batches"])])


def answers_per_call(inputs):
    return len(inputs.batches[0][0])


def open_program(cell, inputs, device):
    import triple_accel_tpu_torch as ta

    def call(batch):
        return np.asarray(ta.hamming_batch(batch[0], batch[1],
                                           device=device))
    return call


def open_control(cell, inputs, device, sampled):
    # a guarantee broken: the last byte of a row is not compared
    return lambda batch: (batch[0][:, :-1] != batch[1][:, :-1]).sum(1)


def keep(out, indices):
    return len(out), np.asarray(out)


def work(cell, inputs, b, kept):
    return {"pairs": len(inputs.batches[b][0])}


def bound(cell, inputs, b, kept):
    return cost_model.roofline(inputs.batches[b][0].size * 2, 0)


def expected(cell, inputs, sample, device):
    return {(b, i): int((inputs.batches[b][0][i] != inputs.batches[b][1][i])
                        .sum()) for b, i in sample}
"""


def test_a_cell_of_a_new_kind_added_by_files_alone(tmp_path):
    root = _checkout(tmp_path)
    before = _files(root / "portbench")
    pb = root / "portbench"
    (pb / "kinds" / "hamming.py").write_text(HAMMING_KIND)
    (pb / "configs" / "rows64.json").write_text(json.dumps(
        {"row_bytes": 64}))
    (pb / "mixes" / "rows.json").write_text(json.dumps(
        {"kind": "hamming", "rows_per_call": 16, "batches": 3,
         "reference_sample": 10}))
    (pb / "end_to_end" / "rows_per_s.py").write_text(
        "def read(run):\n"
        "    return run['work']['pairs'] / run['window_s']\n")
    (pb / "metrics" / "launches_per_call.rows.py").write_text(
        "def read(ctx):\n"
        "    n = ctx['record']['launches_per_call']\n"
        "    return float(sum(n.values())) if n else None\n")
    path = root / "BENCHMARK.json"
    spec = json.loads(path.read_text())
    spec["end_to_end"].append({"name": "rows_per_s", "unit": "pairs/s",
                               "better": "higher", "bound": 0.05,
                               "source": "host_clock",
                               "workloads": ["rows64.rows"]})
    path.write_text(json.dumps(spec))
    _add_entries(
        root, {"name": "rows64", "source": "x",
               "file": "portbench/configs/rows64.json", "reduced": [],
               "why": "x"},
        {"name": "rows64.rows", "config": "rows64", "traffic": "rows",
         "chips": 1, "why": "x"},
        {"name": "launches_per_call.rows", "unit": "launches",
         "better": "lower", "source": "program_counter", "layer": "x",
         "moves": "rows_per_s", "workloads": ["rows64.rows"]}, ())
    cell = find_cell("rows64.rows", str(root))
    r = run_cell(cell, SEED, 0.3, False, device="cpu", emit=_quiet)
    assert r["correct"] and r["attempted"] >= 1
    assert set(r["metrics"]) == {"rows_per_s", "setup_s"}
    r = run_cell(cell, SEED, 0.3, True, device="cpu", emit=_quiet)
    assert r["correct"]
    r = run_cell(cell, SEED, 0.3, False, device="cpu", control=True,
                 emit=_quiet)
    assert r["correct"] is False
    assert r["checks"]["mismatched_answers"]["value"] > 0
    after = _files(pb)
    assert all(after[p] == v for p, v in before.items())


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source",
                   "workloads"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves",
                  "workloads"},
}


def test_benchmark_json_names_units_and_limits():
    path = os.path.join(ROOT, "BENCHMARK.json")
    assert os.path.getsize(path) <= 64 * 1024
    spec = json.load(open(path))
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert 1 <= spec["run_seconds"] <= 51
    assert 2 + 14 * 24 * (spec["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200
    names = set()
    for section, keys in KEYS.items():
        for e in spec[section]:
            assert set(e) <= keys and set(e) >= keys - {"workloads"}
            assert NAME.match(e["name"]), e["name"]
            assert e["name"] not in names
            names.add(e["name"])
            for key in ("why", "layer", "source"):
                if key in e:
                    assert 1 <= len(e[key]) <= 200 and "\n" not in e[key]
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
    for c in spec["configs"]:
        assert c["file"].startswith("portbench/") and os.path.exists(
            os.path.join(ROOT, c["file"]))
        assert all(NAME.match(k) for k in c["reduced"])
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in spec["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for w in spec["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1
        cell = find_cell(w["name"])
        got = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in got and len(got) >= 2 and cell.per_layer
        assert os.path.exists(os.path.join(
            ROOT, "portbench", "mixes", w["traffic"] + ".json"))
        assert os.path.exists(os.path.join(
            ROOT, "portbench", "kinds", cell.mix["kind"] + ".py"))
    for m in spec["per_layer"]:
        assert m["moves"] in e2e
        assert os.path.exists(os.path.join(ROOT, "portbench", "metrics",
                                           m["name"] + ".py"))
        for w in m.get("workloads", []):
            assert w in e2e[m["moves"]].get("workloads", [w])
    assert spec["command"][1].startswith(spec["paths"][0] + "/")
