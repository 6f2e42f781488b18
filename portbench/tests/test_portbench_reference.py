"""The plain reference against the program on the CPU, at a tiny fan and
a tiny Huygens stage: the reference's f64 trace is the program's f64
engine, its Huygens sum the program's f64 path; the program's fast
engine (K1 and K2 as their twins) and K3's twin lie near both."""

import numpy as np
import pytest
import torch

from portbench.kinds import align
from portbench.reference import huygens as ref_huygens
from portbench.reference import systems as ref_systems
from portbench.reference import trace as ref_trace

N = 17
CPU = torch.device("cpu")


def configs(bench):
    return {c["name"]: bench._json(c["file"])["system"]
            for c in bench.spec["configs"]}


def vector(seed=5):
    return torch.tensor(np.random.default_rng(seed).normal(0, 1e-5, 26),
                        dtype=torch.float64)


@pytest.mark.parametrize("config", ["kb7", "wolter31-euv"])
def test_reference_is_the_f64_engine(bench, config):
    from akbx_torch import systems, trace

    cfg = configs(bench)[config]
    v = vector()
    ref = ref_trace.run(align._system(ref_systems, cfg, CPU)(v), N, v[0])
    got = trace.run(align._system(systems, cfg, CPU)(v), N, N, defocus=v[0],
                    exit_pupil_uniform=False, precision="f64")
    assert torch.equal(ref.valid, got.valid)
    assert float((ref.detcenter - got.detcenter).abs().max()) <= 1e-15
    assert float((ref.total_dist - got.total_dist).abs().max()) <= 1e-12


@pytest.mark.parametrize("config", ["kb7", "wolter31-euv"])
def test_program_step_near_the_reference(bench, config):
    """The timed step's loss, gradient and fields (the fast engine on its
    twins) against the reference's, as the check reads them."""
    from akbx_torch import systems, trace

    cfg = configs(bench)[config]
    v = vector().requires_grad_(True)
    system = align._system(systems, cfg, CPU)(v)
    res = trace.run(system, N, N, defocus=v[0], exit_pupil_uniform=False,
                    precision="pallas")
    loss = align.bench_loss(res)
    loss.backward()
    ref_loss, ref_grad, ref, ref_system = align.reference_step(cfg, v, N,
                                                               CPU)
    assert float(abs(loss.detach().double() - ref_loss) / ref_loss) < 1e-6
    assert align._grad_rel(v.grad, ref_grad) < 1e-5
    numbers = align._field_numbers(align._fields(res, system), ref,
                                   ref_system, N, ref_trace)
    assert numbers["valid_diff"] == 0
    assert numbers["detcenter_m"] < 5e-9 and numbers["w32_m"] < 1e-9
    assert numbers["coeffs_rel"] < 1e-14


def test_reference_huygens_is_the_f64_path():
    from akbx_torch import wave

    rng = np.random.default_rng(3)
    src = torch.tensor(np.array([[0.1], [0.02], [0.0]])
                       + rng.normal(size=(3, 40)) * 1e-3)
    tgt = torch.tensor(np.array([[0.3], [0.0], [0.01]])
                       + rng.normal(size=(3, 30)) * 1e-3)
    re, im = (torch.tensor(rng.normal(size=40)) for _ in range(2))
    ds = torch.tensor(np.abs(rng.normal(size=40)) * 1e-8)
    field = wave.WaveField(src, re, im, ds)
    want = torch.complex(*wave.propagate(field, tgt, 13.5e-9,
                                         backend="xla"))
    got = torch.complex(*ref_huygens.huygens(src, re, im, ds, tgt, 13.5e-9))
    k3 = torch.complex(*wave.propagate(field, tgt, 13.5e-9,
                                       backend="pallas"))
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-12 * scale
    assert float((k3 - got).abs().max()) <= 1e-5 * scale


def test_calc_ds_is_the_program_s():
    from akbx_torch import wave

    pts = torch.tensor(np.random.default_rng(4).normal(size=(3, 7 * 9)))
    assert torch.equal(ref_huygens.calc_ds(pts, 7, 9),
                       wave.calc_ds(pts, 7, 9))
