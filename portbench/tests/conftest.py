"""Fixtures of portbench's CPU tests: the benchmark's cells at a tiny
size, run on the CPU, where the program's kernels run as their plain
PyTorch twins.  Run them from the repository root:

    python -m pytest portbench/tests -q
"""

import os
import sys
import time

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# the traffic of each kind at a size the CPU runs in well under a second
SMALL = {"align": {"fan": 16, "vectors": 64, "checked_steps": 3,
                   "profile_steps": 1},
         "wave": {"side": 17, "geometries": 2, "checked_targets": 64,
                  "checked_chains": 1, "profile_steps": 1}}
SMALL["ring"] = SMALL["wave"]
SEED = 2**31 + 12345


def small_cell(bench, name: str):
    cell = bench.cell(name)
    cell.traffic.update(SMALL[cell.traffic["kind"]])
    return cell


def run_small(bench, name: str, trace: bool = False, seed: int = SEED,
              seconds: float = 0.3) -> dict:
    import torch

    from portbench import harness

    return harness.run_cell(bench, small_cell(bench, name), seed, seconds,
                            trace, torch.device("cpu"), time.perf_counter())


@pytest.fixture(scope="session")
def bench():
    from portbench import harness

    return harness.Bench(ROOT)
