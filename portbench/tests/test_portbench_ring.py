"""The four-card ring cell at a tiny size on the CPU: four processes
over gloo, the harness's collectives and the ring's transfers."""

import json
import os
import subprocess
import sys

import pytest

from portbench import harness

HERE = os.path.dirname(os.path.abspath(__file__))


def run_ranks(trace: bool, world: int = 4, fault: str = ""):
    """The exit code of every rank, and rank 0's standard output."""
    port = harness.free_port()
    env = dict(os.environ, RING_TRACE="1" if trace else "0",
               RING_FAULT=fault)
    procs = [subprocess.Popen([sys.executable,
                               os.path.join(HERE, "ring_ranks.py"), str(r),
                               str(world), str(port)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True)
             for r in range(world)]
    outs = [p.communicate(timeout=600) for p in procs]
    return [p.returncode for p in procs], outs[0][0], outs[0][1]


def result(trace: bool, fault: str = "") -> dict:
    rcs, stdout, stderr = run_ranks(trace, fault=fault)
    assert rcs == [0] * 4, stderr[-3000:]
    return json.loads(stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("trace", [False, True])
def test_ring_cell_on_four_cpu_ranks(bench, trace):
    out = result(trace)
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] % 6 == 0 and out["failed"] == 0
    want = {m["name"] for m in bench.metrics("wolter31.wave-ring-257",
                                             trace)}
    assert set(out["metrics"]) <= want
    if trace:
        assert "ring_skew.wave" in out["metrics"]
    else:
        assert set(out["metrics"]) == want


def test_ring_without_its_exchange_is_not_correct():
    out = result(False, fault="exchange")
    assert out["correct"] is False
    assert any(c["value"] > c["limit"] for c in out["checks"].values())


def test_a_rank_that_loads_akbx_gives_no_result():
    """The JAX package loaded on rank 1 alone: the run exits non-zero and
    rank 0 prints no result."""
    rcs, stdout, stderr = run_ranks(False, fault="akbx")
    assert rcs[0] != 0 and rcs[1] != 0
    assert stdout == ""
    assert "no result" in stderr
