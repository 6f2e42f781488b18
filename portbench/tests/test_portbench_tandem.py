"""The Wolter III+III tandem (``configs/wolter33-tandem.json``) entered the
benchmark as new files alone: its names resolve in the program and in
its own plain reference (``reference/systems_tandem.py``), its cell runs
and reads ``correct`` on the CPU, and its limits catch the planted
faults, the float32 control and a reference whose hyp_V is moved 1 um,
put in through a copy of the benchmark."""

import json
import types

import pytest
import torch
from conftest import SEED, run_small, small_cell
from test_portbench_new_config import (RUN, copy_bench, digests, new_file,
                                       run_in)

from portbench import faults, harness, resolve

CELL = "tandem.align-2048"

TANDEM_MOVED = '''"""The tandem's plain reference, its hyp_V moved 1 um along z."""

import torch

from portbench.reference import systems_tandem
from portbench.reference.systems_tandem import AKBSpec, AlignParams

__all__ = ["AKBSpec", "AlignParams", "build_wolter_3_3_tandem"]


def build_wolter_3_3_tandem(spec, params, **options):
    dz = torch.zeros_like(params.hyp_v)
    dz[5] = 1e-6
    return systems_tandem.build_wolter_3_3_tandem(
        spec, params._replace(hyp_v=params.hyp_v + dz), **options)
'''


def test_the_tandem_s_names_resolve(bench):
    cell = bench.cell(CELL)
    assert cell.config["name"] == "wolter33-tandem"
    assert resolve.unresolved(cell.config) == []
    systems, trace = resolve.reference_modules(cell.config["system"])
    assert systems.__name__ == "portbench.reference.systems_tandem"
    assert trace.__name__ == "portbench.reference.trace"


def test_the_tandem_cell_is_correct(bench):
    out = run_small(bench, CELL)
    assert out["correct"] is True, out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert out["checks"]["valid_diff"]["value"] == 0
    assert out["checks"]["coeffs_rel"]["value"] == 0


@pytest.mark.parametrize("fault", ["half_rays", "moved_point",
                                   "moved_deviation", "moved_opl",
                                   "build_bwd_x2"])
def test_a_broken_path_fails_the_tandem_cell(bench, fault):
    """Each fault the cell's limits were read against, planted in the
    program, fails one of them."""
    with faults.planted(fault, bench.cell(CELL).config):
        out = run_small(bench, CELL)
    assert out["correct"] is False
    assert any(c["value"] > c["limit"] for c in out["checks"].values())


def test_the_float32_control_fails_the_tandem_cell(bench):
    """The tandem names no lower path of the program: its control is the
    plain reference in float32, which fails a limit where the sound run
    passes every one."""
    c = small_cell(bench, CELL)
    dev = torch.device("cpu")
    ctx = types.SimpleNamespace(device=dev, seed=SEED, config=c.config,
                                traffic=c.traffic, chips=1, trace=False)
    st = c.kind.setup(ctx, harness.Spans(dev, False))
    for i in range(3):
        c.kind.step(st, i, None)
    c.kind.window(st, 3)
    c.kind.free(st)
    sound = c.kind.check(st, SEED)
    control = c.kind.control(st, SEED)
    assert all(sound[k] <= c.limits[k] for k in c.limits)
    assert any(control[k] > c.limits[k] for k in c.limits)


def test_a_moved_reference_fails_the_tandem_cell(tmp_path):
    """In a copy: the tandem again, its reference a new module whose hyp_V
    is moved 1 um, with the tandem's limits.  That cell is not correct, on
    ``coeffs_rel`` or ``detcenter_m``, and the tandem's own is; no file of
    the copy changes."""
    root = copy_bench(tmp_path)
    before = digests(root)
    name, moved = "wolter33-moved", "wolter33-moved.align-2048"
    cfg = json.loads((root / "portbench" / "configs"
                      / "wolter33-tandem.json").read_text())
    cfg["name"] = name
    cfg["system"]["reference"] = "tandem_moved"
    new_file(root, f"portbench/configs/{name}.json", json.dumps(cfg))
    new_file(root, "portbench/reference/tandem_moved.py", TANDEM_MOVED)
    new_file(root, f"portbench/workloads/{moved}.json",
             (root / "portbench" / "workloads" / f"{CELL}.json")
             .read_text())
    spec = json.loads((root / "BENCHMARK.json").read_text())
    entry = next(c for c in spec["configs"]
                 if c["name"] == "wolter33-tandem")
    spec["configs"].append(dict(entry, name=name,
                                file=f"portbench/configs/{name}.json"))
    work = next(w for w in spec["workloads"] if w["name"] == CELL)
    spec["workloads"].append(dict(work, name=moved, config=name))
    (root / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    out, err = run_in(root, RUN, moved, CELL)
    assert out is not None, err[-3000:]
    after = digests(root)
    assert {k: after[k] for k in before} == before
    assert out[CELL]["correct"] is True, out[CELL]["checks"]
    bad = out[moved]
    assert bad["correct"] is False
    over = {k for k, c in bad["checks"].items() if c["value"] > c["limit"]}
    assert over & {"coeffs_rel", "detcenter_m"}, bad["checks"]
