"""The Wolter III+III tandem's plain reference
(``portbench/reference/systems_tandem.py``) against the program on the
CPU, at a 17 x 17 fan: its placement is the program's
``build_wolter_3_3_tandem``, its f64 trace the program's f64 engine, and
the program's timed step (the fast engine on its CPU twins) lies near
both; a tandem step records the program's whole span tree.  Imports
nothing of the JAX package."""

import json
import os

import numpy as np
import pytest
import torch

from akbx_torch import spans, systems, trace
from portbench.kinds import align
from portbench.reference import systems_tandem as ref_systems
from portbench.reference import trace as ref_trace

N = 17
CPU = torch.device("cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEP_PATHS = ("systems.build", "trace.run", "trace.run/trace.chief",
              "trace.run/trace.k1", "trace.run/trace.tilt",
              "trace.run/trace.k2", "trace.run/trace.finish",
              "twin.backward", "twin.backward/twin.rebuild",
              "twin.backward/twin.rebuild/trace.chief",
              "twin.backward/twin.vjp")


@pytest.fixture(scope="module")
def cfg():
    with open(os.path.join(ROOT, "portbench", "configs",
                           "wolter33-tandem.json")) as f:
        return json.load(f)["system"]


def vector(seed):
    """The seeded 26-vectors of the benchmark's reference tests (sigma
    1e-5, as the align traffic draws them); seed None: the design."""
    if seed is None:
        return torch.zeros(26, dtype=torch.float64)
    return torch.tensor(np.random.default_rng(seed).normal(0, 1e-5, 26),
                        dtype=torch.float64)


SEEDS = [None, 5, 6]


def built(cfg, v):
    """(the program's system, the reference's) at ``v``."""
    return (align._system(systems, cfg, CPU)(v),
            align._system(ref_systems, cfg, CPU)(v))


def moved(build):
    """``build`` with hyp_V moved 1 um along its local z axis."""
    def broken(spec, params, **options):
        dz = torch.zeros_like(params.hyp_v)
        dz[5] = 1e-6
        return build(spec, params._replace(hyp_v=params.hyp_v + dz),
                     **options)
    return broken


def test_the_config_names_the_program_s_constants(cfg):
    assert cfg["reference"] == "systems_tandem"
    assert (systems.AKBSpec(**cfg["args"])
            == systems.WOLTER_3_3_TANDEM_DEFAULT)


@pytest.mark.parametrize("seed", SEEDS)
def test_the_placement_is_the_program_s(cfg, seed):
    prog, ref = built(cfg, vector(seed))
    assert len(prog.mirrors) == len(ref.mirrors) == 4
    for mp, mr in zip(prog.mirrors, ref.mirrors):
        # a few f64 roundings of a mirror's largest coefficient: both
        # builders run the same products in the same batches
        rel = (mp.coeffs - mr.coeffs).abs().max() / mr.coeffs.abs().max()
        assert float(rel) <= 1e-15
        assert torch.equal(mp.branch, mr.branch)
    # the validity, the fan and the detector distance come from the same
    # edge formulas in both: equal, not near
    assert bool(prog.valid) and bool(ref.valid)
    assert torch.equal(prog.fan_h, ref.fan_h)
    assert torch.equal(prog.fan_v, ref.fan_v)
    assert torch.equal(prog.s2f_middle, ref.s2f_middle)


@pytest.mark.parametrize("seed", SEEDS)
def test_the_reference_trace_is_the_f64_engine(cfg, seed):
    v = vector(seed)
    prog, ref_system = built(cfg, v)
    ref = ref_trace.run(ref_system, N, v[0])
    got = trace.run(prog, N, N, defocus=v[0], exit_pupil_uniform=False,
                    precision="f64")
    assert torch.equal(ref.valid, got.valid) and bool(ref.valid.all())
    # the same f64 operations in the same order on the same mirrors: the
    # bars of the III+I and KB references (an f64 ulp of the ~146-m path
    # is 2.8e-14 m, so the OPL's compensated sum is held to 1e-12)
    assert float((ref.detcenter - got.detcenter).abs().max()) <= 1e-15
    assert float((ref.total_dist - got.total_dist).abs().max()) <= 1e-12


def step_numbers(cfg, v):
    """The timed step's loss, gradient and kept fields (the fast engine on
    its twins) against ``align.reference_step``, as the check reads them:
    (loss_rel, grad_rel, field numbers)."""
    v = v.clone().requires_grad_(True)
    system = align._system(systems, cfg, CPU)(v)
    res = trace.run(system, N, N, defocus=v[0], exit_pupil_uniform=False,
                    precision="pallas")
    loss = align.bench_loss(res)
    loss.backward()
    ref_loss, ref_grad, ref, ref_system = align.reference_step(cfg, v, N,
                                                               CPU)
    loss_rel = float(abs(loss.detach().double() - ref_loss) / ref_loss)
    numbers = align._field_numbers(align._fields(res, system), ref,
                                   ref_system, N, ref_trace)
    return loss_rel, align._grad_rel(v.grad, ref_grad), numbers


@pytest.mark.parametrize("seed", SEEDS)
def test_program_step_near_the_reference(cfg, seed):
    """The bars of the III+I and KB cells' CPU test: the deviations of the
    fast engine are double-f32 (here 1e-11 m at the focus and 6e-12 m of
    OPL at 17^2), its loss and gradient rounded in f32 sums; the placement
    is the same f64."""
    loss_rel, grad_rel, numbers = step_numbers(cfg, vector(seed))
    assert loss_rel < 1e-6
    assert grad_rel < 1e-5
    assert numbers["valid_diff"] == 0
    assert numbers["detcenter_m"] < 5e-9 and numbers["w32_m"] < 1e-9
    assert numbers["coeffs_rel"] < 1e-14


def test_a_moved_reference_fails_the_step_bars(cfg, monkeypatch):
    """With the reference's hyp_V moved 1 um the bars above catch it: the
    test can fail."""
    monkeypatch.setattr(ref_systems, "build_wolter_3_3_tandem",
                        moved(ref_systems.build_wolter_3_3_tandem))
    _, _, numbers = step_numbers(cfg, vector(5))
    assert numbers["coeffs_rel"] >= 1e-14 or numbers["detcenter_m"] >= 5e-9


@pytest.fixture
def spans_on():
    spans.disable()
    spans.take()
    spans.enable("cpu")
    yield
    spans.disable()
    spans.take()


def test_a_tandem_step_records_every_span_once(cfg, spans_on):
    """One tandem step with the program's spans on: the build, the trace
    forward with its five parts and the twin's backward with its two, each
    once; the roots are the step's three layers."""
    spans.step(3)
    step_numbers(cfg, vector(5))
    # the reference step ran under the spans too, and opened none
    recs = spans.take()
    by_path = spans.summary(recs)
    assert set(by_path) == set(STEP_PATHS)
    assert all(d["count"] == 1 for d in by_path.values())
    assert all(r.step == 3 for r in recs)
    assert {r.path for r in recs if r.parent is None} == {
        "systems.build", "trace.run", "twin.backward"}
