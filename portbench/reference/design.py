"""Analytic design and mirror surfaces of the reference: frozen copies of
``akbx_torch/design.py`` (the ellipse and KB definitions) and
``akbx_torch/surfaces.py`` (canonical conics, one figure-free bounce).
Plain PyTorch; imports nothing of the program."""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from portbench.reference import geometry as geo


F64 = torch.float64


def _sqrt(v):
    return torch.sqrt(v) if isinstance(v, torch.Tensor) else math.sqrt(v)


def _f64(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=F64, device=device)


def ell_define(l1, inc, l2, device=None):
    """Ellipse from source distance ``l1``, grazing angle ``inc`` and focus
    distance ``l2``: (a, b, theta1, theta3), the semi-axes and the
    source- and focus-side polar angles of the mirror center, on
    ``device`` (or that of ``l1``)."""
    dev = l1.device if isinstance(l1, torch.Tensor) else device
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
    through the steps taken.  On ``device``."""
    dev = device
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



class Mirror(NamedTuple):
    """A figure-free conic mirror; every field is an f64 tensor."""

    coeffs: torch.Tensor  # (10,)
    branch: torch.Tensor  # scalar +1.0 / -1.0 root selection
    center: torch.Tensor  # (3,) chief-ray center on the surface
    axes: torch.Tensor  # (3,3) rows = local x,y,z in global frame


def make_mirror(coeffs: torch.Tensor, branch=+1.0, center=None,
                axes=None) -> Mirror:
    dev = coeffs.device

    def f64(x, default):
        x = default if x is None else x
        return torch.as_tensor(x, dtype=F64, device=dev)

    return Mirror(coeffs.to(F64), f64(branch, None), f64(center, [0.0] * 3),
                  f64(axes, torch.eye(3)))


def _conic(a, b, plane: str, sign: float, device) -> torch.Tensor:
    a = torch.as_tensor(a, dtype=F64, device=device)
    b = torch.as_tensor(b, dtype=F64, device=device)
    z = torch.zeros((), dtype=F64, device=device)
    one = torch.ones((), dtype=F64, device=device)
    a2 = 1.0 / a ** 2
    b2 = sign / b ** 2
    if plane == "xz":
        return torch.stack([a2, z, b2, z, z, z, z, z, z, -one])
    if plane == "xy":
        return torch.stack([a2, b2, z, z, z, z, z, z, z, -one])
    raise ValueError(plane)


def ellipse_coeffs(a, b, plane: str, device) -> torch.Tensor:
    """Canonical ellipse x^2/a^2 + w^2/b^2 = 1, w = z for a V mirror
    ('xz'), w = y for an H mirror ('xy')."""
    return _conic(a, b, plane, 1.0, device)


def hyperbola_coeffs(a, b, plane: str, device) -> torch.Tensor:
    """Canonical hyperbola x^2/a^2 - w^2/b^2 = 1."""
    return _conic(a, b, plane, -1.0, device)


def intersect_and_reflect(mirror: Mirror, rays: torch.Tensor,
                          origins: torch.Tensor):
    """One bounce: exact quadric intersection and specular reflection.
    Returns (points, reflected_dirs, normals, seg_len, valid)."""
    pts, t, valid = geo.intersect(mirror.coeffs, rays, origins,
                                  branch=mirror.branch)
    n = geo.surface_normal(mirror.coeffs, pts)
    refl = geo.reflect(rays, n, renormalize=False)
    return pts, refl, n, torch.abs(t), valid
