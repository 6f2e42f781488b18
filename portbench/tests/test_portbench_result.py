"""The result line of a run: its keys, its metrics, its checks."""

import json
import os
import subprocess
import sys

import pytest
from conftest import ROOT, run_small

CELLS = ["kb7.align-2048", "wolter31.align-2048", "wolter31.wave-257"]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_result_line(bench, cell, trace):
    out = run_small(bench, cell, trace=trace)
    json.dumps(out)
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-1] == "checks"
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] > 0
    assert set(out["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert set(out["checks"]) == set(bench.cell(cell).limits)
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]
    want = {m["name"] for m in bench.metrics(cell, trace)}
    assert set(out["metrics"]) <= want
    if not trace:
        # every end-to-end metric of the cell; on the CPU no device ones
        assert set(out["metrics"]) == want
    for m in out["metrics"].values():
        assert m["value"] > 0 and m["unit"]


def test_no_card_no_result(tmp_path):
    """Without a CUDA card (this machine) the run exits non-zero and
    prints nothing on standard output."""
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "portbench", "run.py"),
         "--workload", "kb7.align-2048", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, cwd=ROOT,
        timeout=300)
    assert proc.returncode != 0 and proc.stdout == ""
