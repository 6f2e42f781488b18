"""The check on imports compares whole top-level module names."""

import os
import subprocess
import sys

import pytest
from conftest import ROOT

from portbench import harness


@pytest.mark.parametrize("names, found", [
    (["akbx_torch", "akbx_torch.trace", "numpy"], []),
    (["akbx_torchy", "akbxx", "jaxtyping", "flaxen"], []),
    (["akbx"], ["akbx"]),
    (["akbx.trace"], ["akbx"]),
    (["jax.numpy", "jaxlib.xla_client"], ["jax", "jaxlib"]),
    (["flax.linen", "torch"], ["flax"]),
])
def test_banned_modules(names, found):
    assert harness.banned_modules(names) == found


def test_the_harness_loads_no_jax():
    """A fresh process that imports the harness, every kind, metric and
    reference module and runs each one-card cell at a tiny size on the
    CPU loads no JAX (the four-card cell: test_portbench_ring.py)."""
    code = (
        "import sys, time, torch\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        f"sys.path.insert(0, {os.path.join(ROOT, 'portbench', 'tests')!r})\n"
        "from conftest import run_small\n"
        "from portbench import harness\n"
        f"b = harness.Bench({ROOT!r})\n"
        "for m in b.spec['end_to_end'] + b.spec['per_layer']:\n"
        "    b.reader(m['name'])\n"
        "import portbench.reference.huygens, portbench.reference.trace\n"
        "import portbench.kinds.ring\n"
        "for w in b.spec['workloads']:\n"
        "    if w['chips'] == 1:\n"
        "        run_small(b, w['name'], seconds=0.1)\n"
        "print(harness.banned_modules())\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().splitlines()[-1] == "[]"
