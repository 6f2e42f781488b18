"""Every configuration, cell and metric of BENCHMARK.json is found by
its name, and a new cell or metric needs only new files and entries."""

import json
import os
import shutil

import pytest
from conftest import ROOT, run_small

from portbench import harness


def test_every_cell_resolves(bench):
    for w in bench.spec["workloads"]:
        cell = bench.cell(w["name"])
        assert cell.chips == w["chips"]
        assert cell.config["name"] == w["config"]
        for fn in ("setup", "step", "window", "roofline", "free", "check",
                   "control"):
            assert callable(getattr(cell.kind, fn))


def test_every_config_file_is_under_paths(bench):
    for c in bench.spec["configs"]:
        assert c["file"].startswith("portbench/configs/")
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]


def test_every_metric_has_a_reader(bench):
    for group in ("end_to_end", "per_layer"):
        for m in bench.spec[group]:
            assert callable(bench.reader(m["name"]))


def test_every_per_layer_metric_moves_an_end_to_end_one(bench):
    e2e = {m["name"]: m for m in bench.spec["end_to_end"]}
    for m in bench.spec["per_layer"]:
        moved = e2e[m["moves"]]
        assert set(m["workloads"]) <= set(moved.get("workloads",
                                                     m["workloads"]))


@pytest.mark.parametrize("cell", ["kb7.align-2048", "wolter31.wave-257"])
def test_a_new_cell_and_metric_need_only_new_files(tmp_path, cell):
    """In a copy of the benchmark: a new traffic file, a new cell's limits,
    a new metric's reader and their entries; nothing that is there
    changes, and the new cell runs and reports the new metric."""
    root = tmp_path / "repo"
    shutil.copytree(os.path.join(ROOT, "portbench"), root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    old = next(w for w in spec["workloads"] if w["name"] == cell)
    traffic = json.load(open(root / "portbench" / "traffic"
                             / (old["traffic"] + ".json")))
    (root / "portbench" / "traffic" / "dummy.json").write_text(
        json.dumps(traffic))
    limits = json.load(open(root / "portbench" / "workloads"
                            / (cell + ".json")))
    new = dict(old, name=cell + ".dummy", traffic="dummy")
    (root / "portbench" / "workloads" / (new["name"] + ".json")).write_text(
        json.dumps(limits))
    (root / "portbench" / "metrics" / "dummy_steps.py").write_text(
        "def read(rec):\n    return float(len(rec['step_s']))\n")
    spec["workloads"].append(new)
    spec["end_to_end"].append({"name": "dummy_steps", "unit": "steps",
                               "better": "higher", "bound": 0.25,
                               "source": "host_clock",
                               "workloads": [new["name"]]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    out = run_small(harness.Bench(str(root)), new["name"])
    assert out["metrics"]["dummy_steps"]["value"] == out["attempted"] / (
        6 if "wave" in cell else 1)
    assert "setup_s" in out["metrics"]
