"""Analytic optical design (port of :mod:`akbx.design`).

* ``ell_define`` / ``kb_define``: ellipse and KB pair definitions, with
  the KB focal-coincidence fixed point;
* ``EllipseNA``: the closed-form ellipse from (l_i1, l_o1, theta_g1,
  NA_out), its quadratics in the stable q-form;
* ``design_ell_v`` / ``design_ell_h`` / ``design_kb``: the NA-based KB
  design; the H mirror is matched to the V mirror by scipy's
  differential evolution over a numpy objective (``_ell_quick_np``), on
  the host, as in akbx;
* ``wolter_iii_angles`` / ``wolter_i_angles``: Wolter layout solvers;
* ``KBDesignManager``: the memoised design with a ``ParamsDesign.txt``
  record.

Everything but the DE searches is differentiable in its float arguments
under autograd.  Tensors are f64 on the caller's device (default: the
card).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from akbx_torch import device_of
from akbx_torch.core import geometry as geo

F64 = torch.float64


def _sqrt(v):
    return torch.sqrt(v) if isinstance(v, torch.Tensor) else math.sqrt(v)


def _f64(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=F64, device=device)


def ell_define(l1, inc, l2, device=None):
    """Ellipse from source distance ``l1``, grazing angle ``inc`` and focus
    distance ``l2``: (a, b, theta1, theta3), the semi-axes and the
    source- and focus-side polar angles of the mirror center.  On
    ``device``, else on that of the first tensor argument, else on the
    card."""
    dev = device_of(next((x for x in (l1, inc, l2)
                          if isinstance(x, torch.Tensor)), None), device)
    l1, inc, l2 = (_f64(x, dev) for x in (l1, inc, l2))
    theta1 = torch.atan(l2 * torch.sin(2.0 * inc)
                        / (l1 + l2 * torch.cos(2.0 * inc)))
    a = (l1 + l2) / 2.0
    b = torch.sqrt(l1 * l2 * torch.sin(inc) ** 2)
    theta3 = torch.asin(l1 * torch.sin(theta1) / l2)
    return a, b, theta1, theta3


def ellipse_y(a, b, x):
    """y on the ellipse at axial position x (focus frame at source)."""
    return torch.sqrt(b**2 - (b * (x - _sqrt(a**2 - b**2)) / a) ** 2)


def hyperbola_y(a, b, x):
    """y on the hyperbola at axial position x (focus frame at source)."""
    return torch.sqrt(-(b**2) + (b * (x - _sqrt(a**2 + b**2)) / a) ** 2)


def _na(a, b, xs, xe, s2f):
    ys = ellipse_y(a, b, xs)
    ye = ellipse_y(a, b, xe)
    na = torch.sin(torch.abs(torch.atan(ye / (s2f - xe))
                             - torch.atan(ys / (s2f - xs)))) / 2.0
    return ys, ye, na


def calc_na(a, b, theta1, l1, mirror_length, device=None):
    """NA subtended by a mirror of ``mirror_length`` centred at polar
    angle ``theta1`` on the ellipse (a, b)."""
    dev = device_of(next((x for x in (a, b, theta1, l1, mirror_length)
                          if isinstance(x, torch.Tensor)), None), device)
    a, b, theta1, l1 = (_f64(x, dev) for x in (a, b, theta1, l1))
    s2f = torch.sqrt(a**2 - b**2) * 2.0
    xs = l1 * torch.cos(theta1) - mirror_length / 2.0
    xe = l1 * torch.cos(theta1) + mirror_length / 2.0
    return _na(a, b, xs, xe, s2f)[2]


@dataclasses.dataclass
class KBDesign:
    """Output of :func:`kb_define` (akbx's field names); every field is an
    f64 scalar tensor."""

    a_h: torch.Tensor
    b_h: torch.Tensor
    a_v: torch.Tensor
    b_v: torch.Tensor
    l1v: torch.Tensor
    l2v: torch.Tensor
    xh_s: torch.Tensor
    xh_e: torch.Tensor
    yh_s: torch.Tensor
    yh_e: torch.Tensor
    theta1_h: torch.Tensor
    theta3_h: torch.Tensor
    accept_h: torch.Tensor
    na_h: torch.Tensor
    xv_s: torch.Tensor
    xv_e: torch.Tensor
    yv_s: torch.Tensor
    yv_e: torch.Tensor
    theta1_v: torch.Tensor
    theta3_v: torch.Tensor
    accept_v: torch.Tensor
    na_v: torch.Tensor
    s2f_h: torch.Tensor
    gap: torch.Tensor


def kb_define(l1h, l2h, inc_h, mlen_h, wd_v, inc_v, mlen_v, gapf=0.0,
              tol=1e-9, max_iter=200, device=None) -> KBDesign:
    """A KB pair from its 7-parameter definition.  The second mirror's
    source distance follows the fixed point ``l1v += 0.9 (s2f_h - s2f_v -
    gapf)`` until the two source-focus distances coincide to ``tol``, or
    for ``max_iter`` steps: akbx's ``lax.while_loop`` as a Python loop on
    tensors (one host read of the condition a step), differentiable
    through the steps taken.  On ``device``, else on that of the first
    tensor argument, else on the card."""
    dev = device_of(next((x for x in (l1h, l2h, inc_h, mlen_h, wd_v, inc_v,
                                      mlen_v, gapf)
                          if isinstance(x, torch.Tensor)), None), device)
    l1h, l2h, inc_h, mlen_h, wd_v, inc_v, mlen_v, gapf = (
        _f64(x, dev) for x in (l1h, l2h, inc_h, mlen_h, wd_v, inc_v, mlen_v,
                               gapf))
    a_h, b_h, t1h, t3h = ell_define(l1h, inc_h, l2h)
    s2f_h = torch.sqrt(a_h**2 - b_h**2) * 2.0
    xh_s = l1h * torch.cos(t1h) - mlen_h / 2.0
    xh_e = l1h * torch.cos(t1h) + mlen_h / 2.0
    yh_s, yh_e, na_h = _na(a_h, b_h, xh_s, xh_e, s2f_h)
    accept_h = torch.abs(yh_e - yh_s)

    l2v = wd_v + mlen_v / 2.0
    l1v = l1h + (l2h - wd_v - mlen_v / 2.0) - gapf

    def s2f_v_of(l1v):
        a_v, b_v, _, _ = ell_define(l1v, inc_v, l2v)
        return torch.sqrt(a_v**2 - b_v**2) * 2.0

    for _ in range(max_iter):
        step = s2f_h - s2f_v_of(l1v) - gapf
        if not bool(torch.abs(step) >= tol):
            break
        l1v = l1v + step * 0.9

    a_v, b_v, t1v, t3v = ell_define(l1v, inc_v, l2v)
    s2f_v = torch.sqrt(a_v**2 - b_v**2) * 2.0
    xv_s = l1v * torch.cos(t1v) - mlen_v / 2.0
    xv_e = l1v * torch.cos(t1v) + mlen_v / 2.0
    yv_s, yv_e, na_v = _na(a_v, b_v, xv_s, xv_e, s2f_v)
    accept_v = torch.abs(yv_e - yv_s)
    gap = xv_s - xh_e
    return KBDesign(a_h, b_h, a_v, b_v, l1v, l2v, xh_s, xh_e, yh_s, yh_e,
                    t1h, t3h, accept_h, na_h, xv_s, xv_e, yv_s, yv_e,
                    t1v, t3v, accept_v, na_v, s2f_h, gap)


def wolter_iii_angles(a_hyp, b_hyp, org_hyp, a_ell, b_ell, org_ell, theta1):
    """Layout angles/lengths of a Wolter III (hyperbola-then-ellipse) pair
    in plain f64.  Returns (theta2, theta3, theta4, theta5, l1, l2, l3, l4).
    """
    l2 = (4 * a_hyp**2 + (org_hyp * 2) ** 2
          - 4 * a_hyp * (org_hyp * 2) * torch.cos(theta1)) / (4 * org_hyp - 4 * a_hyp)
    l1 = 2 * a_hyp + l2
    theta2 = torch.asin(org_hyp * 2 * torch.sin(theta1) / l2) / 2
    theta3 = torch.asin(l1 * torch.sin(theta1) / l2)
    l4 = ((org_ell**2 - 2 * org_ell * a_ell * torch.cos(theta3) + a_ell**2)
          / (a_ell - org_ell * torch.cos(theta3)))
    l3 = 2 * a_ell - l2 - l4
    theta5 = torch.asin((2 * a_ell - l4) * torch.sin(theta3) / l4)
    theta4 = torch.asin(2 * org_ell * torch.sin(theta3) / l4) / 2
    return theta2, theta3, theta4, theta5, l1, l2, l3, l4


def wolter_i_angles(a_hyp, b_hyp, org_hyp, a_ell, b_ell, org_ell, theta1):
    """Layout angles/lengths of a Wolter I (ellipse-then-hyperbola) pair in
    plain f64.  Returns (theta2, theta3, theta4, theta5, l1, l2, l3, l4).
    """
    l1 = b_ell**2 / (a_ell - org_ell * torch.cos(theta1))
    l2 = 2 * a_ell - l1
    theta2 = torch.asin(torch.sqrt(b_ell**2 / (l1 * l2)))
    theta3 = 2 * theta2 - theta1
    l3 = b_hyp**2 / (org_hyp * torch.cos(theta3) - a_hyp)
    l4 = l3 - 2 * a_hyp
    theta4 = torch.asin(torch.sqrt(b_hyp**2 / (l3 * l4)))
    theta5 = 2 * theta4 + theta3
    return theta2, theta3, theta4, theta5, l1, l2, l3, l4


class EllipseNA:
    """Closed-form ellipse from (l_i1, l_o1, theta_g1, NA_out), attribute
    for attribute as akbx's (the reference's ``Ell`` class).  Solves the
    quadratic in cos(theta_i1), then walks the mirror edges and centres
    analytically.  Every attribute is an f64 scalar tensor on ``device``,
    else on that of the first tensor argument, else on the card."""

    def __init__(self, l_i1, l_o1, theta_g1, na_o, allcalc: bool = True,
                 device=None):
        dev = device_of(next((x for x in (l_i1, l_o1, theta_g1, na_o)
                              if isinstance(x, torch.Tensor)), None), device)
        self.l_i1 = l_i1 = _f64(l_i1, dev)
        self.l_o1 = l_o1 = _f64(l_o1, dev)
        self.theta_g1 = theta_g1 = _f64(theta_g1, dev)
        self.na_o = na_o = _f64(na_o, dev)
        cos, sin, tan = torch.cos, torch.sin, torch.tan

        a = (l_i1 + l_o1) / 2.0
        b2 = l_i1 * l_o1 * sin(theta_g1) ** 2
        f = torch.sqrt(a**2 - b2)
        self.a, self.b2, self.f = a, b2, f

        # cos(theta_i1) from the ellipse membership of the input-side edge,
        # the '-' root in the stable q-form
        A = l_i1**2 * (1.0 / a**2 - 1.0 / b2)
        B = -2.0 * l_i1 * f / a**2
        C = f**2 / a**2 + l_i1**2 / b2 - 1.0
        _, t, _ = geo.solve_quadratic(A, B, C)
        self.theta_i1 = torch.acos(t)
        self.x_1 = l_i1 * cos(self.theta_i1)
        self.theta_o1 = 2 * theta_g1 - self.theta_i1
        self.theta_o2 = self.theta_o1 + na_o
        # output-side edge radius from the polar-angle quadratic
        A2 = cos(self.theta_o2) ** 2 / a**2 + sin(self.theta_o2) ** 2 / b2
        B2 = -2.0 * f * cos(self.theta_o2) / a**2
        C2 = f**2 / a**2 - 1.0
        self.l_o2, _, _ = geo.solve_quadratic(A2, B2, C2)

        if allcalc:
            self.b = torch.sqrt(b2)
            self.l_i2 = 2 * a - self.l_o2
            self.x_3 = self.l_o2 * cos(self.theta_o2)
            self.x_2 = l_o1 * cos(self.theta_o1) - self.x_3
            self.theta_i2 = torch.acos((self.x_1 + self.x_2) / self.l_i2)
            self.m1 = tan(self.theta_o1) / tan(self.theta_i1)
            self.m2 = tan(self.theta_o2) / tan(self.theta_i2)
            self.y_1 = l_i1 * sin(self.theta_i1)
            self.y_2 = self.l_o2 * sin(self.theta_o2)
            self.edge = self.x_1 + self.x_2
            self.omega_default = (self.theta_i1 + self.theta_o1
                                  + self.theta_i2 + self.theta_o2) / 2
            # mirror center by width
            self.x_cnt_m_wid = self.x_1 + self.x_2 / 2
            self.y_cnt_m_wid = torch.sqrt(
                b2 * (1 - ((self.x_cnt_m_wid - f) / a) ** 2))
            self.theta_i_cnt_m_wid = torch.atan(self.y_cnt_m_wid
                                                / self.x_cnt_m_wid)
            self.theta_o_cnt_m_wid = torch.atan(
                self.y_cnt_m_wid / (2 * f - self.x_cnt_m_wid))
            self.omega_cnt_m_wid = (self.theta_i_cnt_m_wid
                                    + self.theta_o_cnt_m_wid)
            # output-angle center
            self.theta_o_cnt_o_angle = (self.theta_o1 + self.theta_o2) / 2
            A3 = (cos(self.theta_o_cnt_o_angle) ** 2 / a**2
                  + sin(self.theta_o_cnt_o_angle) ** 2 / b2)
            B3 = -2 * f * cos(self.theta_o_cnt_o_angle) / a**2
            C3 = f**2 / a**2 - 1.0
            self.l_o_cnt_o_angle, _, _ = geo.solve_quadratic(A3, B3, C3)
            self.x_cent_o_angle = 2 * f - self.l_o_cnt_o_angle * cos(
                self.theta_o_cnt_o_angle)
            self.y_cent_o_angle = self.l_o_cnt_o_angle * sin(
                self.theta_o_cnt_o_angle)
            self.l_i_cnt_o_angle = 2 * a - self.l_o_cnt_o_angle
            self.theta_i_cnt_o_angle = torch.acos(self.x_cent_o_angle
                                                  / self.l_i_cnt_o_angle)
            self.omega_cnt_o_angle = (self.theta_i_cnt_o_angle
                                      + self.theta_o_cnt_o_angle)
            self.theta_i_cnt_angle = (self.theta_i1 + self.theta_i2) / 2
            # mirror-center aperture parameters
            self.x_centre = self.x_1 + self.x_2 / 2
            self.y_centre = torch.sqrt(
                b2 * (1 - ((self.x_centre - f) / a) ** 2))
            self.p_centre = torch.sqrt(self.x_centre**2 + self.y_centre**2)
            self.q_centre = 2 * a - self.p_centre
            self.theta_centre = torch.asin(
                torch.sqrt(b2 / (self.p_centre * self.q_centre)))
            self.mirr_length = self.x_2

    @property
    def aperture(self):
        return self.mirr_length * self.theta_centre


def design_ell_v(l_i1, l_o1, theta_g1, na_o_sin, device=None) -> EllipseNA:
    """The V mirror of an NA-based KB design: the output NA is
    ``2 arcsin(na_o_sin)``."""
    na_o = np.float64(np.arcsin(na_o_sin) * 2)
    return EllipseNA(l_i1, l_o1, theta_g1, na_o, device=device)


def _ell_quick_np(l_i1, l_o1, theta_g1, na_o):
    """(l_o2, x_1, f) of the NA-based ellipse in numpy with stable roots:
    the objective of the host-side DE searches (an ``EllipseNA`` of
    tensors costs ~ms of dispatch an evaluation; DE makes 1e4-1e5)."""
    a = (l_i1 + l_o1) / 2.0
    b2 = l_i1 * l_o1 * np.sin(theta_g1) ** 2
    f2 = a * a - b2
    if f2 <= 0:
        raise FloatingPointError("degenerate ellipse")
    f = np.sqrt(f2)

    def stable_roots(A, B, C):
        D = B * B - 4 * A * C
        if D <= 0 or A == 0:
            raise FloatingPointError("no real root")
        q = -0.5 * (B + np.copysign(np.sqrt(D), B))
        r1, r2 = q / A, C / q
        return (r2, r1) if B >= 0 else (r1, r2)  # (plus, minus)

    A = l_i1**2 * (1.0 / a**2 - 1.0 / b2)
    B = -2.0 * l_i1 * f / a**2
    C = f**2 / a**2 + l_i1**2 / b2 - 1.0
    _, t = stable_roots(A, B, C)
    if not -1.0 <= t <= 1.0:
        raise FloatingPointError("cos(theta_i1) out of range")
    theta_i1 = np.arccos(t)
    x_1 = l_i1 * t
    theta_o1 = 2 * theta_g1 - theta_i1
    theta_o2 = theta_o1 + na_o
    A2 = np.cos(theta_o2) ** 2 / a**2 + np.sin(theta_o2) ** 2 / b2
    B2 = -2.0 * f * np.cos(theta_o2) / a**2
    C2 = f**2 / a**2 - 1.0
    l_o2, _ = stable_roots(A2, B2, C2)
    return l_o2, x_1, f


def design_ell_h(ell1: EllipseNA, target_l_o2, target_gap, ast, na_o_sin_h,
                 seed: int | None = 0, de_maxiter: int = 10000):
    """The H mirror matched to the V mirror ``ell1`` by differential
    evolution (scipy, akbx's arguments): match the working distance
    (l_o2), the gap-consistent x_1 and the focus position.  Returns
    ``(ell1, ell2)``, ``ell2`` on ``ell1``'s device."""
    from scipy.optimize import differential_evolution

    target_x_1 = float(ell1.edge + target_gap)
    target_f = float(ell1.f + ast)
    l_i1 = float(ell1.l_i2 + target_gap)
    theta_g1 = float(ell1.theta_g1 / 3)
    na_o = np.float64(np.arcsin(na_o_sin_h) * 2)

    def objective(params):
        li, lo, tgz = params
        try:
            l_o2, x_1, f = _ell_quick_np(li, lo, tgz, na_o)
            err_l_o2 = l_o2 - float(target_l_o2)
            err_x_1 = x_1 - target_x_1
            err_f = f - target_f
        except (FloatingPointError, ValueError):
            return np.inf
        val = np.sqrt((err_l_o2 / float(target_l_o2)) ** 2
                      + (err_f / target_f) ** 2
                      + (err_x_1 / target_x_1) ** 2)
        return val if np.isfinite(val) else np.inf

    bounds = [(l_i1 - 1, l_i1 + 1), (0.001, 2), (1e-9, np.pi / 4)]
    result = differential_evolution(
        objective, bounds, strategy="best1bin", maxiter=de_maxiter, popsize=15,
        tol=1e-6, mutation=(0.5, 1), recombination=0.7, seed=seed, polish=True,
        init="sobol", x0=[l_i1, float(ell1.l_o2), theta_g1])
    _, opt_l_o1, opt_theta_g1 = result.x
    ell2 = EllipseNA(l_i1, opt_l_o1, opt_theta_g1, na_o,
                     device=ell1.l_i1.device)
    return ell1, ell2


def design_kb(l_i1, l_o1, theta_g1, na_o_sin_v, na_o_sin_h,
              target_l_o2, target_gap, ast, seed: int | None = 0,
              device=None):
    """The NA-based KB design: the V mirror in closed form, the H mirror by
    :func:`design_ell_h`.  Returns ``(ell_v, ell_h)``."""
    ell1 = design_ell_v(l_i1, l_o1, theta_g1, na_o_sin_v, device=device)
    return design_ell_h(ell1, target_l_o2, target_gap, ast, na_o_sin_h,
                        seed=seed)


class KBDesignManager:
    """Lazy, memoised KB design with a ``ParamsDesign.txt`` record.

    Holds the design inputs, runs the (DE-based) :func:`design_kb` at most
    once per input set, and writes the inputs to ``params_path`` whenever
    a solve happens, so a run directory records the design it traced.
    The cache is keyed on the inputs: ``set_design`` with the same values
    never recomputes, and a changed value invalidates it.
    """

    def __init__(self, params_path: str | None = "ParamsDesign.txt",
                 seed: int | None = 0, device=None):
        self.params_path = params_path
        self.seed = seed
        self.device = device
        self._key = None
        self._pair: tuple[EllipseNA, EllipseNA] | None = None

    def set_design(self, l_i1, l_o1, theta_g1, na_o_sin, target_l_o2,
                   target_gap, ast, na_o_sin_h=None):
        key = tuple(float(v) for v in
                    (l_i1, l_o1, theta_g1, na_o_sin,
                     na_o_sin if na_o_sin_h is None else na_o_sin_h,
                     target_l_o2, target_gap, ast))
        if key != self._key:
            self._key = key
            self._pair = None

    def get_design(self) -> tuple[EllipseNA, EllipseNA]:
        if self._key is None:
            raise RuntimeError("set_design() before get_design()")
        if self._pair is None:
            (l_i1, l_o1, theta_g1, na_v, na_h,
             target_l_o2, target_gap, ast) = self._key
            if self.params_path:
                with open(self.params_path, "w") as f:
                    f.write(f"l_i1 = {l_i1}\n")
                    f.write(f"l_o1 = {l_o1}\n")
                    f.write(f"theta_g1 = {theta_g1}\n")
                    f.write(f"na_o_sin = {na_v}\n")
                    f.write(f"target_l_o2 = {target_l_o2}\n")
                    f.write(f"target_gap = {target_gap}\n")
                    f.write(f"ast = {ast}\n")
            self._pair = design_kb(l_i1, l_o1, theta_g1, na_v, na_h,
                                   target_l_o2, target_gap, ast,
                                   seed=self.seed, device=self.device)
        return self._pair
