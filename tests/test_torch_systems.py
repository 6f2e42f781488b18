"""Parity of akbx_torch.systems.build_wolter_3_1 with akbx's builder, at
zero and at a seeded misalignment, in all three ``unit_coupled`` modes."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from akbx import design as jdesign
from akbx import systems as jsys
from akbx_torch import convert
from akbx_torch import design as tdesign
from akbx_torch import systems as tsys

torch.set_num_threads(2)

# seeded misalignment at the scale alignment works at: ~10 urad rotations,
# ~10 um decenters
SEEDED = np.random.default_rng(1).normal(0.0, 1e-5, 26)
CASES = [(name, uc, vec) for name, vec in (("zero", np.zeros(26)),
                                           ("seeded", SEEDED))
         for uc in (False, True, "h")]


def _assert_same_system(t, j):
    """Coefficients to <= 1e-9 of each mirror's largest |coefficient|
    (both run the placement in double-f64 and round once, but the chief
    pre-trace and the layout angles pass through f64 libm calls that may
    round differently); centers and axes to <= 1e-12."""
    for tm, jm in zip(t.mirrors, j.mirrors):
        jc = np.asarray(jm.coeffs)
        np.testing.assert_allclose(tm.coeffs.numpy(), jc, rtol=0,
                                   atol=1e-9 * np.abs(jc).max())
        np.testing.assert_allclose(tm.center.numpy(), np.asarray(jm.center),
                                   rtol=0, atol=1e-12)
        np.testing.assert_allclose(tm.axes.numpy(), np.asarray(jm.axes),
                                   rtol=0, atol=1e-12)
        assert float(tm.branch) == float(jm.branch)
    for f in ("s2f_middle", "fan_h", "fan_v", "source"):
        np.testing.assert_allclose(getattr(t, f).numpy(),
                                   np.asarray(getattr(j, f)), rtol=1e-13,
                                   atol=1e-15)
    assert bool(t.valid) == bool(j.valid)


@pytest.mark.parametrize("name,unit_coupled,vec", CASES,
                         ids=[f"{n}-{u}" for n, u, _ in CASES])
def test_build_wolter_3_1_matches_akbx(name, unit_coupled, vec):
    j = jsys.build_wolter_3_1(jsys.WOLTER_3_1_DEFAULT,
                              jsys.AlignParams.from_vector(vec),
                              unit_coupled=unit_coupled)
    t = tsys.build_wolter_3_1(tsys.WOLTER_3_1_DEFAULT,
                              convert.align_params_from_numpy(vec,
                                                                 device="cpu"),
                              unit_coupled=unit_coupled)
    _assert_same_system(t, j)


def test_build_fan_centering_mean_matches_akbx():
    """``fan_centering="mean"`` (the III_I engine's setting)."""
    j = jsys.build_wolter_3_1(jsys.WOLTER_3_1_DEFAULT,
                              jsys.AlignParams.from_vector(SEEDED),
                              fan_centering="mean")
    t = tsys.build_wolter_3_1(tsys.WOLTER_3_1_DEFAULT,
                              tsys.AlignParams.from_vector(SEEDED,
                                                           device="cpu"),
                              fan_centering="mean")
    _assert_same_system(t, j)


def test_design_conics_match_akbx():
    """The plain-f64 layout angle chain and the conic heights of the design
    module: the same formulas in f64 on both sides, <= 1e-12 relative (the
    chain cancels ~8 digits of angles ~1e-4 rad, and libm's asin/cos may
    round differently)."""
    S = jsys.WOLTER_3_1_DEFAULT
    th = np.array([5.2e-5, 5.9e-5])
    args = (S.a_hyp_v, S.b_hyp_v, S.org_hyp_v, S.a_ell_v, S.b_ell_v,
            S.org_ell_v)
    j_all = jdesign.wolter_iii_angles(*args, jnp.asarray(th))
    t_all = tdesign.wolter_iii_angles(*args, torch.from_numpy(th))
    for j, t in zip(j_all, t_all):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-12)
    x = np.array([146.0, 146.03])   # on both conics' mirror branches
    for name, a, b in (("ellipse_y", S.a_ell_h, S.b_ell_h),
                       ("hyperbola_y", S.a_hyp_v, S.b_hyp_v)):
        t = getattr(tdesign, name)(a, b, torch.from_numpy(x)).numpy()
        assert np.isfinite(t).all() and (t > 0).all()
        np.testing.assert_allclose(
            t, np.asarray(getattr(jdesign, name)(a, b, jnp.asarray(x))),
            rtol=1e-12)


def test_convert_params_and_spec():
    spec = convert.spec_from_akbx(
        dataclasses.asdict(jsys.WOLTER_3_1_DEFAULT))
    assert spec == tsys.WOLTER_3_1_DEFAULT
    p = convert.align_params_from_numpy(SEEDED, device="cpu")
    np.testing.assert_array_equal(p.to_vector().numpy(), SEEDED)
    np.testing.assert_array_equal(
        np.asarray(jsys.AlignParams.from_vector(SEEDED).hyp_h),
        p.hyp_h.numpy())
    with pytest.raises(ValueError):
        convert.align_params_from_numpy(np.zeros(25), device="cpu")


def test_build_differentiable_in_params():
    """The placement is differentiable in the 26-vector under autograd."""
    v = torch.zeros(26, dtype=torch.float64, requires_grad=True)
    s = tsys.build_wolter_3_1(tsys.WOLTER_3_1_DEFAULT,
                              tsys.AlignParams.from_vector(v, device="cpu"))
    s.mirrors[3].coeffs[7].backward()
    assert torch.isfinite(v.grad).all() and v.grad.abs().sum() > 0


def test_shift_z_bug_emulation_not_ported():
    """The reference's shift_z-bug emulation, once not ported, now is: at
    the seeded misalignment it matches akbx's at the bars above, and it
    moves the linear-y term ``h`` of the hyp_H quadric away from the
    correct placement's by more than 1e-3 (akbx documents ~2e-2)."""
    j = jsys.build_wolter_3_1(jsys.WOLTER_3_1_DEFAULT,
                              jsys.AlignParams.from_vector(SEEDED),
                              ref_shift_z_bug=True)
    p = tsys.AlignParams.from_vector(SEEDED, device="cpu")
    t = tsys.build_wolter_3_1(tsys.WOLTER_3_1_DEFAULT, p,
                              ref_shift_z_bug=True)
    _assert_same_system(t, j)
    good = tsys.build_wolter_3_1(tsys.WOLTER_3_1_DEFAULT, p)
    assert abs(float(t.mirrors[3].coeffs[7] - good.mirrors[3].coeffs[7])) \
        > 1e-3
