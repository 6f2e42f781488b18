"""The port's design layer against akbx on the CPU: ``EllipseNA``, the DE
designer (``design_ell_h`` / ``design_kb`` / ``KBDesignManager``),
``wolter_i_angles``, and ``design_na`` (the NA-constrained solve with its
implicit gradient, ``design_kb_aperture``, ``mirror_profile``,
``design_raytrace``).

What is held to what, and why:

* ``EllipseNA`` is closed form: every attribute to 1e-14 of itself.  The
  two packages' ``acos`` differ by up to 1 ulp, so ``theta_i1`` may too,
  and ``x_2`` (a difference of ~146 m lengths) carries that as ~3e-15.
* ``design_ell_h``'s DE objective is the same numpy function, so from the
  same inputs the DE follows the same path: ``x`` bit for bit.  The V
  mirror's ``l_o2`` (one of those inputs) may differ by an ulp between the
  packages, and the matched design is degenerate at the 1e-10 level (many
  ``x`` give a zero objective), so ``design_kb`` end to end is held on
  its design quantities to 1e-9 (measured 4.8e-11 on ``l_o2``).
* ``solve_na_constrained``: its residuals are differences of ~146 m
  lengths (rounding ~3e-14 m) and the Jacobian's smallest singular value
  is ~1e-9 at akbx's defaults, so any f64 Newton root lies up to ~1e-3 of
  theta from the exact one: both packages converge (residuals exactly 0)
  to roots 6e-4 apart.  The witness is the exact solution, 50 digits in
  mpmath (:func:`exact_na`): the port within 1e-3 of it in every field
  (measured <= 1.9e-4; akbx <= 3.9e-4), and within 2e-3 of akbx.  akbx's
  own bars (tests/test_design_na.py) hold, except its rtol 1e-4 on
  ``na_i_result``, which is below this conditioning: akbx reads 6.8e-5,
  the port 1.5e-4.  The implicit gradient of l_o2 is held to the exact
  derivative and to akbx's ``jax.grad`` within 1e-2 (measured 1.4e-3 and
  2.7e-3; akbx's own is 1.3e-3 from the exact).
"""

import mpmath as mp
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from akbx import design as jd
from akbx import design_na as jn
from akbx_torch import design as td
from akbx_torch import design_na as tn

torch.set_num_threads(2)

NA_CASE = dict(x_1=146.0, x_3=0.55, na_i=1e-4, na_o=0.02)
KB_CASE = (145.75, 1.05, 0.21, 0.0082, 0.0082, 0.32, 0.2287, 0.0)
ELL_ATTRS = ("a", "b", "b2", "f", "theta_i1", "theta_i2", "theta_o1",
             "theta_o2", "l_o2", "l_i2", "x_1", "x_2", "x_3", "y_1", "y_2",
             "m1", "m2", "edge", "omega_default", "theta_i_cnt_m_wid",
             "omega_cnt_m_wid", "omega_cnt_o_angle", "theta_i_cnt_angle",
             "x_centre", "p_centre", "q_centre", "theta_centre",
             "mirr_length")
DESIGN_REL = 1e-9   # design_kb end to end (degenerate DE optimum)
NA_REL = 2e-3       # solve_na_constrained against akbx (conditioning)


def _rel(a, b):
    a, b = float(a), float(b)
    return abs(a - b) / max(abs(b), 1e-300)


@pytest.mark.parametrize("args", [(146.0, 0.3, 0.14, 0.082),
                                  (145.75, 1.05, 0.21, 0.0082),
                                  (48.6, 0.33, 0.006, 0.002)])
def test_ellipse_na(args):
    """design_ell_v -> EllipseNA, every attribute, and the geometric
    invariants akbx's tests hold (tests/test_design.py)."""
    j = jd.design_ell_v(*args)
    t = td.design_ell_v(*args, device="cpu")
    for k in ELL_ATTRS:
        assert getattr(t, k).dtype == torch.float64
        assert _rel(getattr(t, k), getattr(j, k)) < 1e-14, k
    assert _rel(t.aperture, j.aperture) < 1e-14
    x1, y1 = float(t.x_1), float(t.y_1)
    a, b2, f = float(t.a), float(t.b2), float(t.f)
    np.testing.assert_allclose((x1 - f) ** 2 / a**2 + y1**2 / b2, 1.0,
                               rtol=1e-6)
    np.testing.assert_allclose(float(t.l_o2 + t.l_i2), 2 * a, rtol=1e-12)


def test_ell_quick_np_is_akbx():
    rng = np.random.default_rng(7)
    for li, lo, tg in zip(rng.uniform(145, 147, 20), rng.uniform(0.1, 2, 20),
                          rng.uniform(1e-3, 0.2, 20)):
        try:
            want = jd._ell_quick_np(li, lo, tg, 0.0164)
        except FloatingPointError:
            with pytest.raises(FloatingPointError):
                td._ell_quick_np(li, lo, tg, 0.0164)
            continue
        assert td._ell_quick_np(li, lo, tg, 0.0164) == want


def test_design_ell_h_same_inputs_same_x(monkeypatch):
    """From akbx's V mirror (its floats as tensors), the port's DE takes
    akbx's path exactly: the same x and H mirror."""
    import scipy.optimize as so

    seen = []
    de = so.differential_evolution

    def record(*a, **kw):
        r = de(*a, **kw)
        seen.append(r)
        return r

    monkeypatch.setattr(so, "differential_evolution", record)
    ej = jd.design_ell_v(*KB_CASE[:4])
    _, hj = jd.design_ell_h(ej, 0.32, 0.2287, 0.0, 0.0082, seed=0)

    class V:  # akbx's V mirror, as f64 tensors
        pass

    ev = V()
    for k in ("edge", "f", "l_i2", "theta_g1", "l_o2", "l_i1"):
        setattr(ev, k, torch.tensor(float(getattr(ej, k)),
                                    dtype=torch.float64))
    _, ht = td.design_ell_h(ev, 0.32, 0.2287, 0.0, 0.0082, seed=0)
    np.testing.assert_array_equal(seen[1].x, seen[0].x)
    assert seen[1].fun == seen[0].fun
    for k in ELL_ATTRS:
        assert _rel(getattr(ht, k), getattr(hj, k)) < 1e-14, k


@pytest.fixture(scope="module")
def kb_pair():
    return (jd.design_kb(*KB_CASE, seed=0),
            td.design_kb(*KB_CASE, seed=0, device="cpu"))


def test_design_kb(kb_pair):
    """End to end: the V mirror closed form, the H mirror's matched
    quantities within DESIGN_REL of akbx, and the targets met."""
    (vj, hj), (vt, ht) = kb_pair
    for k in ELL_ATTRS:
        assert _rel(getattr(vt, k), getattr(vj, k)) < 1e-14, k
    for k in ("l_o2", "x_1", "f", "a", "b", "l_o1", "theta_g1",
              "mirr_length"):
        assert _rel(getattr(ht, k), getattr(hj, k)) < DESIGN_REL, k
    np.testing.assert_allclose(float(ht.l_o2), 0.32, atol=1e-6)


def test_kb_design_manager(tmp_path):
    """akbx's manager test (tests/test_design.py) on the port."""
    path = str(tmp_path / "ParamsDesign.txt")
    m = td.KBDesignManager(params_path=path, seed=0, device="cpu")
    with pytest.raises(RuntimeError):
        m.get_design()
    m.set_design(145.75, 1.05, 0.21, 0.0082, 0.32, 0.2287, 0.0)
    e1, e2 = m.get_design()
    assert m.get_design() == (e1, e2)
    m.set_design(145.75, 1.05, 0.21, 0.0082, 0.32, 0.2287, 0.0)
    assert m.get_design()[0] is e1
    text = open(path).read()
    assert "l_i1 = 145.75" in text and "target_gap = 0.2287" in text
    np.testing.assert_allclose(float(e2.l_o2), 0.32, atol=1e-6)
    m.set_design(145.75, 1.05, 0.21, 0.0082, 0.32, 0.2287, 1e-4)
    assert m._pair is None


def test_wolter_i_angles():
    """The Wolter I layout chain at the reference's "1型" H-pair constants."""
    a_e, b_e = 73.1076714403445, 0.517019631143022
    a_h, b_h = 0.0077, 0.00432051448679384
    org_e, org_h = np.sqrt(a_e**2 - b_e**2), np.sqrt(a_h**2 + b_h**2)
    theta1 = 0.000145746388538841
    j = jd.wolter_i_angles(a_h, b_h, org_h, a_e, b_e, org_e, theta1)
    t = td.wolter_i_angles(a_h, b_h, org_h, a_e, b_e, org_e,
                           torch.tensor(theta1, dtype=torch.float64))
    for a, b in zip(t, j):
        assert _rel(a, b) < 1e-12


# --- design_na -----------------------------------------------------------

def exact_na(x_1, x_3, na_i, na_o, guess):
    """The NA-constrained design in 50-digit arithmetic: akbx's residuals
    and completion, the root by mpmath's Newton from ``guess`` (theta_i1,
    theta_o2).  Returns a dict of mpf fields."""
    with mp.workdps(50):
        x_1, x_3, na_i, na_o = (mp.mpf(v) for v in (x_1, x_3, na_i, na_o))
        cos, sin, tan = mp.cos, mp.sin, mp.tan

        def res(ti1, to2):
            ti2, to1 = ti1 - na_i, to2 - na_o
            li1, lo2 = x_1 / cos(ti1), x_3 / cos(to2)
            alpha = (lo2 * sin((ti2 + to2) / 2) ** 2) / (
                li1 * sin((ti1 + to1) / 2) ** 2)
            li2 = (x_1 - x_3) / (cos(ti2) - alpha * cos(to1))
            x_2 = li2 * cos(ti2) - x_1
            lo1 = (x_3 + x_2) / cos(to1)
            a = (li1 + lo1) / 2
            b2 = li1 * lo1 * sin((ti1 + to1) / 2) ** 2
            return [(li1 + lo1) - (li2 + lo2),
                    (x_1 + x_2 + x_3) - 2 * mp.sqrt(a**2 - b2)]

        ti1, to2 = (mp.re(v) for v in mp.findroot(
            res, tuple(mp.mpf(g) for g in guess), tol=mp.mpf(10) ** -36,
            maxsteps=200))
        to1 = to2 - na_o
        const1 = x_1 * sin((ti1 + to1) / 2) ** 2 / (cos(ti1) * cos(to1))
        A = 1 / cos(to1) ** 2 - 1
        B = 4 * (x_1 / (2 * cos(to1) * cos(ti1)) - x_1 / 2 - const1)
        C = x_1**2 * (1 / cos(ti1) ** 2 - 1)
        # the discriminants sit at ~0 (a near-double root), as the f64
        # code clamps them
        X = (-B + mp.sqrt(max(B * B - 4 * A * C, 0))) / (2 * A)
        b2, f = X * const1, (x_1 + X) / 2
        a = mp.sqrt(f**2 + b2)
        A2 = 1 / a**2 + tan(to2) ** 2 / b2
        B2, C2 = -2 * f / a**2, f**2 / a**2 - 1
        x3r = (-B2 + mp.sqrt(max(B2 * B2 - 4 * A2 * C2, 0))) / (2 * A2)
        x_2 = X - x3r
        ti2 = mp.atan(x3r * tan(to2) / (x_1 + x_2))
        l_i1 = x_1 / cos(ti1)
        return dict(theta_i1=ti1, theta_i2=ti2, theta_o1=to1, theta_o2=to2,
                    x_2=x_2, x_3=x3r, l_i1=l_i1, l_i2=(x_1 + x_2) / cos(ti2),
                    l_o1=2 * a - l_i1, l_o2=x3r / cos(to2), a=a, b2=b2, f=f,
                    na_i_result=ti1 - ti2)


def test_na_residuals():
    """The two constraints at seeded angles: the same numbers to the
    rounding of ~146 m lengths."""
    rng = np.random.default_rng(8)
    args = [NA_CASE[k] for k in ("x_1", "x_3", "na_i", "na_o")]
    for th in rng.uniform([3e-4, 0.06], [5e-4, 0.1], (8, 2)):
        j = np.asarray(jn._residuals(jnp.asarray(th), *args))
        t = tn._residuals(torch.tensor(th), *[torch.tensor(a, dtype=torch.float64)
                                              for a in args])
        np.testing.assert_allclose(t.numpy(), j, rtol=0, atol=1e-13)


@pytest.fixture(scope="module")
def na_pair():
    return (jn.solve_na_constrained(**NA_CASE),
            tn.solve_na_constrained(**NA_CASE, device="cpu"))


def test_solve_na_constrained(na_pair):
    """akbx's own bars (tests/test_design_na.py), the exact solution and
    akbx's."""
    from test_design_na import oracle_residuals

    j, d = na_pair
    exact = exact_na(**NA_CASE, guess=(float(d.theta_i1),
                                       float(d.theta_o2)))
    for k, v in exact.items():
        assert _rel(getattr(d, k), v) < 1e-3, k
        assert _rel(getattr(d, k), getattr(j, k)) < NA_REL, k
    eq1, eq2 = oracle_residuals(float(d.theta_i1), float(d.theta_o2),
                                **NA_CASE)
    assert abs(eq1) < 1e-9 and abs(eq2) < 1e-9
    assert abs(float(d.check_a_error)) < 1e-10
    assert abs(float(d.check_na_i_error)) < 1e-7
    assert abs(float(d.check_x_3_error)) < 1e-4
    assert d.iterations < 50
    np.testing.assert_allclose(float(d.l_i1 + d.l_o1), 2 * float(d.a),
                               rtol=1e-12)
    np.testing.assert_allclose(float(d.l_i2 + d.l_o2), 2 * float(d.a),
                               rtol=1e-10)
    np.testing.assert_allclose(float(d.x_1 + d.x_2 + d.x_3), 2 * float(d.f),
                               rtol=1e-12)
    np.testing.assert_allclose(float(d.theta_o2 - d.theta_o1),
                               NA_CASE["na_o"], rtol=1e-12)


def test_solve_na_constrained_gradient():
    """The implicit-function gradient of l_o2 in (na_o, x_3) at the
    design-na defaults against the exact derivative (central differences
    of :func:`exact_na` at a 1e-12 step, 50 digits) and akbx's
    ``jax.grad``, and akbx's own bar on d l_o2 / d x_3 (0.9 .. 1.2)."""
    def lo2_j(v):
        return jn.solve_na_constrained(146.0, v[1], 1e-4, v[0]).l_o2

    gj = np.asarray(jax.grad(lo2_j)(jnp.asarray([0.02, 0.55])))
    v = torch.tensor([0.02, 0.55], dtype=torch.float64, requires_grad=True)
    d = tn.solve_na_constrained(146.0, v[1], 1e-4, v[0])
    gt, = torch.autograd.grad(d.l_o2, v)
    guess = (float(d.theta_i1.detach()), float(d.theta_o2.detach()))
    with mp.workdps(50):
        h = mp.mpf(10) ** -12

        def lo2(na_o, x_3):
            return exact_na(146.0, x_3, 1e-4, na_o, guess)["l_o2"]

        exact = [float((lo2(mp.mpf(0.02) + h, 0.55)
                        - lo2(mp.mpf(0.02) - h, 0.55)) / (2 * h)),
                 float((lo2(0.02, mp.mpf(0.55) + h)
                        - lo2(0.02, mp.mpf(0.55) - h)) / (2 * h))]
    np.testing.assert_allclose(gt.numpy(), exact, rtol=1e-2)
    np.testing.assert_allclose(gt.numpy(), gj, rtol=1e-2)
    assert 0.9 < float(gt[1]) < 1.2


def test_mirror_profile_and_raytrace():
    """The profile and its quadratic fit (numpy's scaled-column polyfit, by
    QR), and the 2D design trace, on akbx's test ellipse."""
    ej = jd.design_ell_v(48.6, 0.33, 0.006, 0.002)
    et = td.design_ell_v(48.6, 0.33, 0.006, 0.002, device="cpu")
    xj, yj, cj, rj = jn.mirror_profile(ej)
    xt, yt, ct, rt = tn.mirror_profile(et)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-15)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0,
                               atol=1e-12 * np.abs(np.asarray(yj)).max())
    # the coefficients of a quadratic over a 0.3 m span at 48.6 m carry
    # the fit's condition number (~1e8): the fitted values and the RoC
    fit_t = np.polyval(ct.numpy(), xt.numpy())
    fit_j = np.polyval(np.asarray(cj), np.asarray(xj))
    assert np.abs(fit_t - fit_j).max() < 1e-11 * np.abs(np.asarray(yj)).max()
    assert _rel(rt, rj) < 1e-7
    assert np.abs(fit_t - yt.numpy()).max() < 1e-2 * np.ptp(yt.numpy())
    np.testing.assert_allclose(ct.numpy(), np.polyfit(xt.numpy(),
                                                      yt.numpy(), 2),
                               rtol=1e-7)

    oj = jn.design_raytrace(ej, 2e-3, n_points=64)
    ot = tn.design_raytrace(et, 2e-3, n_points=64)
    for k in oj:
        a = np.asarray(oj[k])
        np.testing.assert_allclose(ot[k].numpy(), a, rtol=0,
                                   atol=1e-12 * np.abs(a).max(), err_msg=k)
    extents = np.ptp(ot["spots"].numpy(), axis=1)
    assert extents[2] == pytest.approx(extents.min())


APERTURE_ARGS = (48.6, 0.002, 0.002, 0.1, 0.0)


def test_design_kb_aperture():
    """At maxiter 1 and an inner DE of 10 generations (akbx's slow settings
    are below): the outer DE reads floats of EllipseNA pairs built by each
    package; here its path is akbx's, to the same x and fun (inf: no
    feasible design after one generation) and the same H mirror."""
    kw = dict(target_aperture_h=0.0005, maxiter=1, seed=1,
              inner_de_maxiter=10)
    j = jn.design_kb_aperture(*APERTURE_ARGS, **kw)
    t = tn.design_kb_aperture(*APERTURE_ARGS, **kw, device="cpu")
    np.testing.assert_array_equal(t[2], j[2])
    assert t[3] == j[3]
    for k in ("l_o2", "x_1", "f", "mirr_length", "theta_centre"):
        assert _rel(getattr(t[1], k), getattr(j[1], k)) < DESIGN_REL, k


@pytest.mark.slow
def test_design_kb_aperture_converges():
    """akbx's slow settings: a finite optimum whose aperture is within 2e-4
    of the target (akbx's bar), and akbx's fun within 1e-6."""
    kw = dict(target_aperture_h=0.0005, maxiter=8, seed=1,
              inner_de_maxiter=60)
    j = jn.design_kb_aperture(*APERTURE_ARGS, **kw)
    t = tn.design_kb_aperture(*APERTURE_ARGS, **kw, device="cpu")
    assert np.isfinite(t[3])
    assert abs(float(t[1].mirr_length * t[1].theta_centre) - 0.0005) < 2e-4
    assert abs(t[3] - j[3]) < 1e-6
