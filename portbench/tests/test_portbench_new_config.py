"""A new configuration enters the benchmark as new files alone: its file
names its own plain reference (``system.reference``, a module of
``portbench/reference/``), the kinds check against that module, and a
run whose names do not resolve ends before any set-up.

The copies run in a fresh process whose ``portbench`` is the copy's, as
a run from a checkout resolves it; the program is the repository's."""

import hashlib
import json
import os
import shutil
import subprocess
import sys

import pytest
from conftest import ROOT, SEED

from portbench import resolve
from portbench.reference import systems as ref_systems
from portbench.reference import trace as ref_trace

KB7_AGAIN = '''"""KB7's plain reference under a name of its own."""

from portbench.reference.systems import AlignParams, KBSpec, build_kb

__all__ = ["AlignParams", "KBSpec", "build_kb"]
'''

KB7_MOVED = '''"""KB7's plain reference, its V mirror moved 1 um along z."""

import torch

from portbench.reference import systems
from portbench.reference.systems import AlignParams, KBSpec

__all__ = ["AlignParams", "KBSpec", "build_kb"]


def build_kb(spec, params, **options):
    dz = torch.zeros_like(params.hyp_v)
    dz[5] = 1e-6
    return systems.build_kb(spec, params._replace(hyp_v=params.hyp_v + dz),
                            **options)
'''

KB7_NO_BUILDER = '''"""KB7's plain reference without its builder."""

from portbench.reference.systems import AlignParams, KBSpec

__all__ = ["AlignParams", "KBSpec"]
'''

STUB_KIND = '''"""A kind whose set-up leaves a mark and stops the run."""

import os


def setup(ctx, spans):
    open(os.path.join(os.path.dirname(__file__), "setup_ran"), "w").close()
    raise RuntimeError("the stub kind's set-up ran")
'''

# the window of ``run_small`` held to a fixed number of steps, so that two
# cells of one seed check the same steps
RUN = f'''
import json, sys
sys.path.insert(0, "portbench/tests")
from conftest import run_small
from portbench import harness

assert harness.__file__.startswith(sys.argv[1]), harness.__file__


def run(cell):
    left = iter(range(5))
    harness.Ranks.agree = lambda self, flag: next(left) < 4
    out = run_small(harness.Bench(sys.argv[1]), cell, seed={SEED})
    return {{"correct": out["correct"], "checks": out["checks"]}}


print(json.dumps({{c: run(c) for c in sys.argv[2:]}}))
'''

# ``harness.main`` as a run on one card would call it, the card faked up
# to the point where a run on the card starts its world
MAIN = '''
import json, sys
import torch
from portbench import harness

assert harness.__file__.startswith(sys.argv[1]), harness.__file__
torch.cuda.is_available = lambda: True
torch.cuda.device_count = lambda: 1
torch.cuda.get_device_name = lambda device=None: "no card"
harness.start_world = lambda *a, **k: (0, torch.device("cpu"), None, [])
print(json.dumps({"rc": harness.main(sys.argv[1], sys.argv[2], 1, 0.1, False,
                                     0.0)}))
'''


def copy_bench(tmp_path):
    """A copy of the benchmark: ``BENCHMARK.json`` and ``portbench/``."""
    root = tmp_path / "repo"
    shutil.copytree(os.path.join(ROOT, "portbench"), root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    return root


def digests(root) -> dict:
    """The SHA-256 of every file of ``portbench/`` under ``root``."""
    out = {}
    for where, dirs, files in os.walk(root / "portbench"):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for name in files:
            path = os.path.join(where, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = hashlib.sha256(
                    f.read()).hexdigest()
    return out


def new_file(root, rel: str, text: str):
    path = root / rel
    assert not path.exists(), rel
    path.write_text(text)


def add_config(root, name: str, system: dict, traffic: str = "align-2048",
               module: str | None = None, source: str | None = None) -> str:
    """A configuration ``name``: kb7's with ``system`` over kb7's system,
    ``source`` as its reference module ``module``, and its cell on
    ``traffic`` with kb7's limits, each a new file, and their entries in
    ``BENCHMARK.json``.  Returns the cell's name."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    kb7 = json.loads((root / "portbench" / "configs" / "kb7.json")
                     .read_text())
    new_file(root, f"portbench/configs/{name}.json", json.dumps(
        dict(kb7, name=name, system=dict(kb7["system"], **system)),
        indent=1))
    if source is not None:
        new_file(root, f"portbench/reference/{module}.py", source)
    cell = f"{name}.{traffic}"
    new_file(root, f"portbench/workloads/{cell}.json",
             (root / "portbench" / "workloads" / "kb7.align-2048.json")
             .read_text())
    entry = next(c for c in spec["configs"] if c["name"] == "kb7")
    spec["configs"].append(dict(entry, name=name,
                                file=f"portbench/configs/{name}.json"))
    work = next(w for w in spec["workloads"] if w["name"] == "kb7.align-2048")
    spec["workloads"].append(dict(work, name=cell, config=name,
                                  traffic=traffic))
    if traffic == "align-2048":
        for m in spec["end_to_end"]:
            if m["name"] == "align_rays_per_s":
                m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return cell


def run_in(root, code: str, *args) -> tuple:
    """``code`` in a fresh process at ``root``, whose ``portbench`` is the
    copy's and ``akbx_torch`` the repository's: (the last line of its
    standard output as JSON, or None; its standard error)."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = os.pathsep.join([str(root), ROOT])
    proc = subprocess.run([sys.executable, "-c", code, str(root), *args],
                          cwd=root, env=env, capture_output=True, text=True,
                          timeout=600)
    lines = proc.stdout.strip().splitlines()
    return (json.loads(lines[-1]) if proc.returncode == 0 and lines
            else None), proc.stderr


@pytest.mark.parametrize("source, same", [(KB7_AGAIN, True),
                                          (KB7_MOVED, False)])
def test_a_new_config_needs_only_new_files(tmp_path, source, same):
    """kb7 again, its reference a new module: the cell reads kb7's checks
    value for value; with that module's V mirror moved 1 um it is not
    correct, so the module named is the one used.  No file of the copy
    changes."""
    root = copy_bench(tmp_path)
    before = digests(root)
    cell = add_config(root, "kb7-again", {"reference": "kb7_again"},
                      module="kb7_again", source=source)
    out, err = run_in(root, RUN, cell, "kb7.align-2048")
    assert out is not None, err[-3000:]
    after = digests(root)
    assert {k: after[k] for k in before} == before
    new, old = out[cell], out["kb7.align-2048"]
    assert old["correct"] is True, old["checks"]
    if same:
        assert new["correct"] is True
        assert new["checks"] == old["checks"]
    else:
        assert new["correct"] is False
        over = {k for k, c in new["checks"].items()
                if c["value"] > c["limit"]}
        assert over & {"coeffs_rel", "detcenter_m"}, new["checks"]


@pytest.mark.parametrize("system, source, said", [
    ({"reference": "kb7_no_builder"}, KB7_NO_BUILDER,
     "portbench.reference.kb7_no_builder has no build_kb"),
    ({"builder": "build_nothing"}, None,
     "akbx_torch.systems has no build_nothing"),
    ({"reference": "../x"}, None, "'../x'"),
    ({"reference": "a.b"}, None, "'a.b'"),
    ({"reference_trace": "no_such_trace"}, None, "'no_such_trace'"),
])
def test_names_that_do_not_resolve_end_the_run_at_once(tmp_path, system,
                                                       source, said):
    """``harness.main`` returns 2 and names what is missing before any
    kind's set-up runs."""
    root = copy_bench(tmp_path)
    new_file(root, "portbench/kinds/stub.py", STUB_KIND)
    new_file(root, "portbench/traffic/stub.json", json.dumps({"kind":
                                                               "stub"}))
    cell = add_config(root, "kb7-broken", system, traffic="stub",
                      module=system.get("reference"), source=source)
    out, err = run_in(root, MAIN, cell)
    assert out == {"rc": 2}, err[-3000:]
    assert said in err and "kb7-broken" in err and "no result" in err
    assert not (root / "portbench" / "kinds" / "setup_ran").exists()


def test_the_default_reference_is_todays(bench):
    """A configuration that names no reference gets the reference's
    ``systems`` and ``trace`` themselves; every configuration's names
    resolve in the program and in its reference."""
    for c in bench.spec["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        system = cfg["system"]
        if not {"reference", "reference_trace"} & set(system):
            modules = resolve.reference_modules(system)
            assert modules[0] is ref_systems and modules[1] is ref_trace
        assert resolve.unresolved(cfg) == []
