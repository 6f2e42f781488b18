"""On a CUDA card: a short run of each one-card cell at its full size is
correct, and its traced run reads every per-layer metric it lists.

    python3 -m pytest -m cuda portbench/tests/test_portbench_cuda.py
"""

import time

import pytest

from portbench import harness


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["kb7.align-2048", "wolter31.align-2048",
                                  "wolter31.wave-257"])
def test_short_run_on_the_card(bench, card, cell):
    c = bench.cell(cell)
    out = harness.run_cell(bench, c, 2**31 + 7, 2.0, True, card,
                           time.perf_counter())
    assert out["correct"] is True, out["checks"]
    assert set(out["metrics"]) == {m["name"]
                                   for m in bench.metrics(cell, True)}
    assert out["device"]["busy_s"] > 0
