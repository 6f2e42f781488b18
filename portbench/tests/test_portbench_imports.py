"""The check on imports compares whole top-level module names."""

import ast
import json
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


REFERENCE = os.path.join(ROOT, "portbench", "reference")


def program_imports(path: str) -> list:
    """What the module at ``path`` imports of the program, JAX or the JAX
    package, at any depth, and every import it makes by a call
    (``importlib.import_module``, ``__import__``), which no plain
    reference needs."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", None))
              in ("import_module", "__import__")):
            found.append(f"line {node.lineno}: an import by a call")
            continue
        else:
            continue
        found += [f"line {node.lineno}: {n}" for n in names
                  if n.split(".")[0] in ("akbx_torch",) + harness.BANNED]
    return found


@pytest.mark.parametrize("name", sorted(
    n for n in os.listdir(REFERENCE) if n.endswith(".py")))
def test_a_reference_module_imports_nothing_of_the_program(name):
    """Every module of ``portbench/reference/``, a configuration's own
    too, is plain PyTorch: the reference never checks the program against
    itself."""
    assert program_imports(os.path.join(REFERENCE, name)) == []


@pytest.mark.parametrize("source", [
    "from akbx_torch import systems\n",
    "def f():\n    import akbx_torch.trace as t\n",
    "from akbx_torch.systems import build_kb as build_kb\n",
    "import importlib\nm = importlib.import_module('akbx_' + 'torch')\n",
    "import jax.numpy\n",
])
def test_the_scan_finds_an_import_of_the_program(tmp_path, source):
    path = tmp_path / "re_export.py"
    path.write_text(source)
    assert program_imports(str(path))


def test_the_reference_loads_nothing_of_the_program():
    """A fresh process that imports every module of
    ``portbench/reference/`` has loaded nothing of the program."""
    names = sorted(n[:-3] for n in os.listdir(REFERENCE)
                   if n.endswith(".py"))
    code = (f"import json, sys\nsys.path.insert(0, {ROOT!r})\n"
            f"for n in {names!r}:\n"
            "    __import__('portbench.reference.' + n)\n"
            "print(json.dumps(sorted({m.split('.')[0]\n"
            "                         for m in sys.modules})))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    loaded = set(json.loads(proc.stdout.strip().splitlines()[-1]))
    assert not loaded & {"akbx_torch", *harness.BANNED}
