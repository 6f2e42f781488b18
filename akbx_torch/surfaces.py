"""Mirror surfaces (port of :mod:`akbx.surfaces`).

A :class:`Mirror` carries the quadric 10-vector, the root branch of the
intersection, a chief-ray center, a local frame and a Legendre figure-error
field: a height map ``h(u, v)`` over the mirror footprint, differentiable
in its coefficients.  A ``(1, 1)`` field is a constant piston.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from akbx_torch import device_of
from akbx_torch.core import geometry as geo

F64 = torch.float64


class Mirror(NamedTuple):
    """A conic mirror; every field is an f64 tensor."""

    coeffs: torch.Tensor  # (10,)
    branch: torch.Tensor  # scalar +1.0 / -1.0 root selection
    center: torch.Tensor  # (3,) chief-ray center on the surface
    axes: torch.Tensor  # (3,3) rows = local x,y,z in global frame
    fig_coeffs: torch.Tensor  # (n_u, n_v) Legendre height coefficients [m]
    uv_center: torch.Tensor  # (2,) local (axial, transverse) footprint center
    uv_half: torch.Tensor  # (2,) footprint half-extents


def make_mirror(coeffs: torch.Tensor, branch=+1.0, center=None, axes=None,
                fig_coeffs=None, uv_center=None, uv_half=None) -> Mirror:
    """A mirror on ``coeffs``' device; the defaults, and a number given
    for a field, are filled there, with no copy from host memory."""
    dev = coeffs.device

    def f64(x, shape=(), fill=0.0):
        if x is None:
            return torch.full(shape, fill, dtype=F64, device=dev)
        if isinstance(x, (int, float)):
            return torch.full((), float(x), dtype=F64, device=dev)
        return torch.as_tensor(x, dtype=F64, device=dev)

    eye = torch.eye(3, dtype=F64, device=dev) if axes is None else f64(axes)
    return Mirror(coeffs.to(F64), f64(branch), f64(center, (3,)), eye,
                  f64(fig_coeffs, (1, 1)), f64(uv_center, (2,)),
                  f64(uv_half, (2,), 1.0))


def _conic(a, b, plane: str, sign: float, device) -> torch.Tensor:
    device = device_of(a, device)
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


def ellipse_coeffs(a, b, plane: str, device=None) -> torch.Tensor:
    """Canonical ellipse x^2/a^2 + w^2/b^2 = 1, w = z for a V mirror
    ('xz'), w = y for an H mirror ('xy').  On ``device``, else on ``a``'s
    if it is a tensor, else on the card."""
    return _conic(a, b, plane, 1.0, device)


def hyperbola_coeffs(a, b, plane: str, device=None) -> torch.Tensor:
    """Canonical hyperbola x^2/a^2 - w^2/b^2 = 1."""
    return _conic(a, b, plane, -1.0, device)


def has_figure(mirror: Mirror) -> bool:
    """Whether the mirror carries a figure-error field beyond a piston."""
    return tuple(mirror.fig_coeffs.shape) != (1, 1)


def _legendre_basis_1d(x: torch.Tensor, order: int) -> torch.Tensor:
    """P_0..P_{order-1} at x by the recurrence; (order, N)."""
    outs = [torch.ones_like(x)]
    if order > 1:
        outs.append(x)
    for n in range(1, order - 1):
        outs.append(((2 * n + 1) * x * outs[n] - n * outs[n - 1]) / (n + 1))
    return torch.stack(outs)


def figure_height(mirror: Mirror, points: torch.Tensor) -> torch.Tensor:
    """Legendre figure-error height [m] at surface points (3, N): the
    modes on the local coordinates ``(axes[0:2] (p - center) - uv_center)
    / uv_half``."""
    local = mirror.axes @ (points - mirror.center[:, None])
    u = (local[0] - mirror.uv_center[0]) / mirror.uv_half[0]
    v = (local[1] - mirror.uv_center[1]) / mirror.uv_half[1]
    n_u, n_v = mirror.fig_coeffs.shape
    Pu = _legendre_basis_1d(u, n_u)  # (n_u, N)
    Pv = _legendre_basis_1d(v, n_v)  # (n_v, N)
    return torch.einsum("uv,un,vn->n", mirror.fig_coeffs, Pu, Pv)


def _with_figure(mirror: Mirror, pts: torch.Tensor, n: torch.Tensor):
    """Displace the points by the figure height along the normal and tilt
    the normal by the height's tangential gradient, a central difference
    with a step of 1e-7 m along two in-surface directions (akbx's, so
    that both packages compute the same thing):

      p' = p + h n,   n' = normalize(n - dh1 t1 - dh2 t2)"""
    h = figure_height(mirror, pts)
    t1 = mirror.axes[0][:, None].expand_as(n)   # local axial (~tangent)
    t2 = geo.normalize(torch.linalg.cross(n, t1, dim=0))
    t1s = geo.normalize(torch.linalg.cross(t2, n, dim=0))  # in-surface axial
    eps = 1e-7
    dh1 = (figure_height(mirror, pts + eps * t1s)
           - figure_height(mirror, pts - eps * t1s)) / (2 * eps)
    dh2 = (figure_height(mirror, pts + eps * t2)
           - figure_height(mirror, pts - eps * t2)) / (2 * eps)
    return pts + h * n, geo.normalize(n - dh1 * t1s - dh2 * t2)


def intersect_and_reflect(mirror: Mirror, rays: torch.Tensor,
                          origins: torch.Tensor):
    """One bounce: exact quadric intersection + figure-error perturbation.

    The figure height displaces the surface along the normal and its
    tangential gradient tilts the normal (first-order exact for nm-scale
    heights, differentiable in ``fig_coeffs``); the segment is measured
    to the displaced point.  A ``(1, 1)`` field is a constant piston.
    Returns (points, reflected_dirs, normals, seg_len, valid).
    """
    pts, t, valid = geo.intersect(mirror.coeffs, rays, origins,
                                  branch=mirror.branch)
    n = geo.surface_normal(mirror.coeffs, pts)
    if has_figure(mirror):
        pts, n = _with_figure(mirror, pts, n)
        seg = torch.sqrt(torch.sum((pts - origins) ** 2, dim=0))
    else:
        # a constant piston height along the normal; rays are unit, so the
        # segment to the displaced point is |t + piston (n . d)|
        piston = mirror.fig_coeffs[0, 0]
        pts = pts + piston * n
        seg = torch.abs(t + piston * torch.sum(n * rays, dim=0))
    refl = geo.reflect(rays, n, renormalize=False)
    return pts, refl, n, seg, valid


def branch_sign(negative: bool, device=None) -> torch.Tensor:
    """The root-branch selector of :func:`geo.intersect` as an f64 scalar:
    -1 for the reference's ``negative=True``, else +1.  On ``device``,
    else on the card."""
    return torch.tensor(-1.0 if negative else 1.0, dtype=F64,
                        device=device_of(None, device))
