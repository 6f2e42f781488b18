"""NA-constrained KB design (port of :mod:`akbx.design_na`): one ellipse
from the four optical requirements (x_1, x_3, NA_in, NA_out).

Two coupled transcendental constraints in (theta_i1, theta_o2):

* eq1: the two edge rays lie on the same ellipse
  (``l_i1 + l_o1 == l_i2 + l_o2``);
* eq2: the foci separation equals the axial span
  (``x_1 + x_2 + x_3 == 2 sqrt(a^2 - b^2)``);

then a closed-form completion of every length and angle, its quadratics
in the stable q-form (:func:`akbx_torch.core.geometry.solve_quadratic`).

The 2x2 system is solved by a damped Newton iteration (a Python loop under
``no_grad``, one host read of the convergence test a step), and its
gradient is the implicit function theorem's, as akbx builds it: the
converged ``theta`` detached, then one Newton step ``theta* - J^-1
F(theta*, params)`` with ``J`` detached, on tensors that autograd sees.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from akbx_torch import design as dsn
from akbx_torch import device_of
from akbx_torch.core import geometry as geo
from akbx_torch.utils import linspace

F64 = torch.float64


def _residuals(theta, x_1, x_3, na_i, na_o):
    """The two ellipse-consistency constraints at theta (2,)."""
    theta_i1, theta_o2 = theta[0], theta[1]
    theta_i2 = theta_i1 - na_i
    theta_o1 = theta_o2 - na_o
    cos, sin = torch.cos, torch.sin

    l_i1 = x_1 / cos(theta_i1)
    l_o2 = x_3 / cos(theta_o2)

    alpha = (l_o2 * sin((theta_i2 + theta_o2) / 2) ** 2) / (
        l_i1 * sin((theta_i1 + theta_o1) / 2) ** 2)
    l_i2 = (x_1 - x_3) / (cos(theta_i2) - alpha * cos(theta_o1))
    x_2 = l_i2 * cos(theta_i2) - x_1
    l_o1 = (x_3 + x_2) / cos(theta_o1)

    a = (l_i1 + l_o1) / 2
    b2 = l_i1 * l_o1 * sin((theta_i1 + theta_o1) / 2) ** 2

    eq1 = (l_i1 + l_o1) - (l_i2 + l_o2)
    eq2 = (x_1 + x_2 + x_3) - 2 * torch.sqrt(a**2 - b2)
    return torch.stack([eq1, eq2])


@dataclasses.dataclass
class NADesign:
    """Solved NA-constrained ellipse (akbx's field names); every field but
    ``iterations`` is an f64 tensor."""

    theta_i1: torch.Tensor
    theta_i2: torch.Tensor
    theta_o1: torch.Tensor
    theta_o2: torch.Tensor
    x_1: torch.Tensor
    x_2: torch.Tensor
    x_3: torch.Tensor
    l_i1: torch.Tensor
    l_i2: torch.Tensor
    l_o1: torch.Tensor
    l_o2: torch.Tensor
    a: torch.Tensor
    b2: torch.Tensor
    f: torch.Tensor
    na_i_result: torch.Tensor
    na_o: torch.Tensor
    # residual checks (the reference's "check" prints)
    check_a_error: torch.Tensor
    check_na_i_error: torch.Tensor
    check_x_3_error: torch.Tensor
    residuals: torch.Tensor
    iterations: int


def _jacobian(theta, x_1, x_3, na_i, na_o):
    return torch.func.jacfwd(
        lambda t: _residuals(t, x_1, x_3, na_i, na_o))(theta)


@torch.no_grad()
def _solve_theta(x_1, x_3, na_i, na_o, tol, max_iter):
    """Damped Newton on the 2x2 system, from the reference's guess."""
    theta = torch.stack([4.0 * na_i, 4.0 * na_o])
    r = _residuals(theta, x_1, x_3, na_i, na_o)
    it = 0
    while it < max_iter and bool(torch.max(torch.abs(r)) > tol):
        J = _jacobian(theta, x_1, x_3, na_i, na_o)
        step = torch.linalg.solve(J, r)
        # damp: never step past positivity of the angles
        scale = torch.clamp(0.5 * torch.min(torch.abs(theta)
                                            / (torch.abs(step) + 1e-300)),
                            max=1.0)
        theta = theta - scale * step
        it += 1
        r = _residuals(theta, x_1, x_3, na_i, na_o)
    return theta, it, r


def solve_na_constrained(x_1, x_3, na_i, na_o, tol: float = 1e-14,
                         max_iter: int = 100, device=None) -> NADesign:
    """Solve the NA-constrained ellipse design from the source-to-edge
    axial distance ``x_1``, the working axial distance ``x_3`` and the
    input and output NAs.  Differentiable in all four.  On ``device``,
    else on that of the first tensor argument, else on the card."""
    dev = device_of(next((x for x in (x_1, x_3, na_i, na_o)
                          if isinstance(x, torch.Tensor)), None), device)
    x_1, x_3, na_i, na_o = (torch.as_tensor(x, dtype=F64, device=dev)
                            for x in (x_1, x_3, na_i, na_o))
    cos, sin, tan = torch.cos, torch.sin, torch.tan

    theta, it, r = _solve_theta(x_1.detach(), x_3.detach(), na_i.detach(),
                                na_o.detach(), tol, max_iter)

    # implicit-function-theorem gradient: one Newton correction at the
    # converged point; the primal moves by ~0 (the residual), the step
    # carries d theta / d params = -J^-1 dF / d params
    F = _residuals(theta, x_1, x_3, na_i, na_o)
    J = _jacobian(theta, x_1.detach(), x_3.detach(), na_i.detach(),
                  na_o.detach())
    theta = theta - torch.linalg.solve(J, F)
    theta_i1, theta_o2 = theta[0], theta[1]

    # closed-form completion, stable roots
    theta_o1 = theta_o2 - na_o
    t_sum = theta_i1 + theta_o1
    const1 = x_1 * sin(t_sum / 2) ** 2 / (cos(theta_i1) * cos(theta_o1))

    A = 1.0 / cos(theta_o1) ** 2 - 1.0
    B = 4.0 * (x_1 / (2 * cos(theta_o1) * cos(theta_i1)) - x_1 / 2 - const1)
    C = x_1**2 * (1.0 / cos(theta_i1) ** 2 - 1.0)
    X, _, _ = geo.solve_quadratic(A, B, C)  # X = x_2 + x_3, the '+' root

    b2 = X * const1
    f = (x_1 + X) / 2
    a = torch.sqrt(f**2 + b2)

    l_i1 = x_1 / cos(theta_i1)
    l_o1 = 2 * a - l_i1

    A2 = 1.0 / a**2 + tan(theta_o2) ** 2 / b2
    B2 = -2.0 * f / a**2
    C2 = f**2 / a**2 - 1.0
    x_3_result, _, _ = geo.solve_quadratic(A2, B2, C2)  # the '+' root
    x_2 = X - x_3_result
    theta_i2 = torch.atan(x_3_result * tan(theta_o2) / (x_1 + x_2))
    l_i2 = (x_1 + x_2) / cos(theta_i2)
    l_o2 = x_3_result / cos(theta_o2)
    na_i_result = theta_i1 - theta_i2

    return NADesign(
        theta_i1=theta_i1, theta_i2=theta_i2, theta_o1=theta_o1,
        theta_o2=theta_o2, x_1=x_1, x_2=x_2, x_3=x_3_result,
        l_i1=l_i1, l_i2=l_i2, l_o1=l_o1, l_o2=l_o2, a=a, b2=b2, f=f,
        na_i_result=na_i_result, na_o=na_o,
        check_a_error=a - (l_i2 + l_o2) / 2,
        check_na_i_error=na_i_result - na_i,
        check_x_3_error=x_3_result - x_3,
        residuals=r, iterations=it)


def design_kb_aperture(l_i1, na_o_sin_v, na_o_sin_h, target_gap, ast,
                       target_aperture_h,
                       bounds=((0.2, 0.4), (0.1, 0.26), (0.03, 0.05)),
                       focus_gap_max: float = 1e-3, m1_min: float = 1000.0,
                       theta_g_max: float = 0.28, seed: int | None = 0,
                       maxiter: int = 100, inner_de_maxiter: int = 200,
                       device=None):
    """Aperture-targeted KB design: differential evolution over (l_o1,
    theta_g1, target_l_o2) minimising the H mirror's aperture error under
    the reference's feasibility limits (focus gap <= ``focus_gap_max``,
    magnification >= ``m1_min``, grazing angles <= ``theta_g_max`` rad).
    A host-side search; each evaluation builds an ``EllipseNA`` pair on
    ``device`` (default: the card).
    Returns (ell_v, ell_h, result_x, result_fun).
    """
    from scipy.optimize import differential_evolution

    def build(params):
        l_o1, theta_g1, target_l_o2 = params
        e1 = dsn.design_ell_v(l_i1, l_o1, theta_g1, na_o_sin_v,
                              device=device)
        return dsn.design_ell_h(e1, target_l_o2, target_gap, ast,
                                na_o_sin_h, seed=seed,
                                de_maxiter=inner_de_maxiter)

    def objective(params):
        try:
            e1, e2 = build(params)
        except (FloatingPointError, ValueError):
            return np.inf
        if float(e1.f - e2.f) > focus_gap_max:
            return np.inf
        if float(e1.m1) < m1_min:
            return np.inf
        tg1 = max(float((e1.theta_i1 + e1.theta_o1) / 2),
                  float((e1.theta_i2 + e1.theta_o2) / 2))
        tg2 = max(float((e2.theta_i1 + e2.theta_o1) / 2),
                  float((e2.theta_i2 + e2.theta_o2) / 2))
        if tg1 > theta_g_max or tg2 > theta_g_max:
            return np.inf
        err = float(e2.mirr_length * e2.theta_centre) - target_aperture_h
        return abs(err) if np.isfinite(err) else np.inf

    result = differential_evolution(
        objective, list(bounds), strategy="best1bin", maxiter=maxiter,
        popsize=15, tol=1e-4, mutation=(0.5, 1), recombination=0.7,
        seed=seed, polish=True)
    e1, e2 = build(result.x)
    return e1, e2, result.x, result.fun


def _profile(ell, n_points):
    x = linspace(ell.x_1, ell.x_1 + ell.x_2, n_points)
    y = ell.b * torch.sqrt(1 - ((x - ell.f) / ell.a) ** 2)
    return x, y


def _polyfit(x: torch.Tensor, y: torch.Tensor, deg: int) -> torch.Tensor:
    """Least-squares polynomial coefficients, highest power first, as
    ``numpy.polyfit``: the Vandermonde columns scaled to unit norm, then a
    QR solve (on any device) and the scale undone."""
    lhs = x[:, None] ** torch.arange(deg, -1, -1, device=x.device)
    scale = torch.sqrt(torch.sum(lhs * lhs, dim=0))
    Q, R = torch.linalg.qr(lhs / scale)
    c = torch.linalg.solve_triangular(R, (Q.T @ y)[:, None], upper=True)
    return c[:, 0] / scale


def mirror_profile(ell, n_points: int = 100):
    """The mirror's height profile and its quadratic fit (radius of
    curvature).  Returns (x, y, poly_coeffs, roc_m)."""
    x, y = _profile(ell, n_points)
    coeffs = _polyfit(x, y, 2)
    roc = 1.0 / (2.0 * coeffs[0])
    return x, y, coeffs, roc


def design_raytrace(ell, size, n_points: int = 100, n_planes: int = 5):
    """2D design-check trace of an :class:`akbx_torch.design.EllipseNA`: a
    finite source of half-extent ``size/2`` reflects off the analytic
    profile; spot y-offsets on ``n_planes`` planes around the nominal focus
    (spacing ``1e-5/na_o``).  Returns a dict with x, y, incident and
    reflected vectors, the planes and the (n_planes, n_points) spots."""
    half = linspace(-size / 2, size / 2, n_points // 2, like=ell.b)
    source = torch.cat([half, -half])
    th = (ell.theta_i1 + ell.theta_i2) / 2
    s, c = torch.sin(th), torch.cos(th)
    x, y = _profile(ell, n_points)
    dydx = -ell.b * (x - ell.f) / (ell.a**2 * torch.sqrt(
        1 - ((x - ell.f) / ell.a) ** 2))
    nvec = torch.stack([torch.ones_like(x), -1.0 / dydx])
    nvec = nvec / torch.sqrt(torch.sum(nvec * nvec, dim=0))
    ivec = torch.stack([x - source * s, y - source * c])
    dot_in = torch.sum(ivec * nvec, dim=0)
    rvec = ivec - 2 * nvec * dot_in
    rvec = rvec / torch.sqrt(torch.sum(rvec * rvec, dim=0))

    steps = torch.arange(n_planes, dtype=F64, device=x.device) - n_planes // 2
    planes = 2 * ell.f + steps * (1e-5 / ell.na_o)
    spots = y[None, :] + (planes[:, None] - x[None, :]) / rvec[0] * rvec[1]
    return {"x": x, "y": y, "ivec": ivec, "rvec": rvec,
            "planes": planes, "spots": spots}
