"""Closed-form best focus and autofocus (port of the part of
:mod:`akbx.align` that the wave export runs).

The spot std along a detector scan is a quadratic in the plane position,
so the minimizing plane is a weighted least-squares crossing point:
``x* = x0 - cov(y, s) / var(s)`` with ``s = dy/dx`` the transverse ray
slope.  One trace per iteration replaces the reference's shrink loops.
"""

from __future__ import annotations

from typing import Callable

import torch

from akbx_torch import trace as tr
from akbx_torch.systems import AlignParams


def best_focus_axis(points, rays, valid, axis: int):
    """Closed-form least-squares focal plane along x for one transverse axis.

    Minimizes std of ``c + (x - x0) * s`` over x, where c is the transverse
    coordinate at the reference plane and s the ray slope.  Returns
    (x_offset_from_points_plane, spot_std_at_focus).
    """
    w = valid.to(points.dtype)
    n = torch.clamp_min(torch.sum(w), 1.0)
    c = points[axis]
    s = rays[axis] / rays[0]
    cm = torch.sum(w * c) / n
    sm = torch.sum(w * s) / n
    cc = c - cm
    sc = s - sm
    cov = torch.sum(w * cc * sc) / n
    var = torch.clamp_min(torch.sum(w * sc * sc) / n, 1e-300)
    dx = -cov / var
    resid = cc + dx * sc
    std = torch.sqrt(torch.sum(w * resid**2) / n)
    return dx, std


def best_focus(result: "tr.TraceResult", x_ref):
    """Best focal-plane positions (absolute x) for H (y) and V (z)."""
    det = tr.detector_points(result, x_ref)
    dx_h, std_h = best_focus_axis(det, result.exit_rays, result.valid, 1)
    dx_v, std_v = best_focus_axis(det, result.exit_rays, result.valid, 2)
    return x_ref + dx_h, x_ref + dx_v, std_h, std_v


def auto_focus(build_fn: Callable[[AlignParams], object], params: AlignParams,
               n: int = 21, iters: int = 3, astig_gain: float = 0.5):
    """Adjust (defocus, astigH) so the H and V foci coincide on the detector.

    Each iteration is one f64 trace of an ``n`` x ``n`` fan plus the closed
    form focus; astigH follows a secant iteration on the focus gap, and
    defocus the midpoint of the two foci.  Returns updated AlignParams.
    """
    def measure(p):
        sys_ = build_fn(p)
        res = tr.run(sys_, n, n, defocus=p.defocus,
                     exit_pupil_uniform=False, tilt_correction=True)
        x_h, x_v, _, _ = best_focus(res.trace, sys_.s2f_middle + p.defocus)
        return x_h, x_v, sys_.s2f_middle

    p = params
    x_h, x_v, s2f = measure(p)
    gap_prev = x_h - x_v
    astig_prev = p.astig_h
    p = p._replace(defocus=(x_h + x_v) / 2 - s2f,
                   astig_h=p.astig_h - astig_gain * gap_prev)
    for _ in range(iters - 1):
        x_h, x_v, s2f = measure(p)
        gap = x_h - x_v
        slope = (gap - gap_prev) / (p.astig_h - astig_prev)
        slope = torch.where(torch.abs(slope) > 1e-6, slope, -1.0)
        astig_prev, gap_prev = p.astig_h, gap
        p = p._replace(defocus=(x_h + x_v) / 2 - s2f,
                       astig_h=p.astig_h - gap / slope)
    return p
