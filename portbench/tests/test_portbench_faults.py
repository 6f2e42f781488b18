"""``correct`` comes out false when the timed path is broken underneath
(the look for a card skipped, the rest of a run driven on the CPU at a
tiny size), and when the control takes the program's place: the
program's own lower path where the configuration names one, else the
plain reference in float32."""

import types

import pytest
import torch
from conftest import SEED, run_small, small_cell

from portbench import faults, harness


FAULTS = [("kb7.align-2048", "half_rays"),
          ("kb7.align-2048", "moved_point"),
          ("kb7.align-2048", "build_bwd_x2"),
          ("wolter31.align-2048", "half_rays"),
          ("wolter31.align-2048", "moved_point"),
          ("wolter31.align-2048", "moved_deviation"),
          ("wolter31.align-2048", "moved_opl"),
          ("wolter31.align-2048", "build_bwd_x2"),
          ("wolter31.wave-257", "half_targets"),
          ("wolter31.wave-257", "moved_value")]


@pytest.mark.parametrize("cell, fault", FAULTS)
def test_a_broken_path_is_not_correct(bench, cell, fault):
    with faults.planted(fault, bench.cell(cell).config):
        out = run_small(bench, cell)
    assert out["correct"] is False
    assert any(c["value"] > c["limit"] for c in out["checks"].values())


@pytest.mark.parametrize("cell", ["kb7.align-2048", "wolter31.align-2048",
                                  "wolter31.wave-257"])
@pytest.mark.parametrize("seed", [SEED, SEED + 1, SEED + 2])
def test_the_control_is_not_correct(bench, cell, seed):
    """The control of ``correct`` fails at least one of the cell's
    limits, and the sound run none."""
    c = small_cell(bench, cell)
    dev = torch.device("cpu")
    ctx = types.SimpleNamespace(device=dev, seed=seed, config=c.config,
                                traffic=c.traffic, chips=1, trace=False)
    st = c.kind.setup(ctx, harness.Spans(dev, False))
    for i in range(3):
        c.kind.step(st, i, None)
    c.kind.window(st, 3)
    c.kind.free(st)
    sound = c.kind.check(st, seed)
    control = c.kind.control(st, seed)
    assert all(sound[k] <= c.limits[k] for k in c.limits)
    assert any(control[k] > c.limits[k] for k in c.limits)
