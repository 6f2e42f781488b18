"""Mirror surfaces (port of :mod:`akbx.surfaces`, without figure errors).

A :class:`Mirror` carries the quadric 10-vector, the root branch of the
intersection, a chief-ray center, a local frame and a Legendre figure-error
field.  Only the figure-free case is ported: a ``fig_coeffs`` other than
``(1, 1)`` (a constant piston) raises.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

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
    dev = coeffs.device

    def f64(x, default):
        x = default if x is None else x
        return torch.as_tensor(x, dtype=F64, device=dev)

    return Mirror(coeffs.to(F64), f64(branch, None), f64(center, [0.0] * 3),
                  f64(axes, torch.eye(3)), f64(fig_coeffs, [[0.0]]),
                  f64(uv_center, [0.0] * 2), f64(uv_half, [1.0] * 2))


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


def ellipse_coeffs(a, b, plane: str, device=None) -> torch.Tensor:
    """Canonical ellipse x^2/a^2 + w^2/b^2 = 1, w = z for a V mirror
    ('xz'), w = y for an H mirror ('xy')."""
    return _conic(a, b, plane, 1.0, device)


def hyperbola_coeffs(a, b, plane: str, device=None) -> torch.Tensor:
    """Canonical hyperbola x^2/a^2 - w^2/b^2 = 1."""
    return _conic(a, b, plane, -1.0, device)


def intersect_and_reflect(mirror: Mirror, rays: torch.Tensor,
                          origins: torch.Tensor):
    """One bounce: exact quadric intersection + constant piston height.

    Returns (points, reflected_dirs, normals, seg_len, valid).
    """
    if tuple(mirror.fig_coeffs.shape) != (1, 1):
        raise NotImplementedError(
            "figure errors are not ported yet (ROADMAP Queue 1, item 3)")
    pts, t, valid = geo.intersect(mirror.coeffs, rays, origins,
                                  branch=mirror.branch)
    n = geo.surface_normal(mirror.coeffs, pts)
    # a (1,1) coeff is a constant piston height along the normal; rays are
    # unit, so the segment to the displaced point is |t + piston (n . d)|
    piston = mirror.fig_coeffs[0, 0]
    pts = pts + piston * n
    seg = torch.abs(t + piston * torch.sum(n * rays, dim=0))
    refl = geo.reflect(rays, n, renormalize=False)
    return pts, refl, n, seg, valid
