"""The f64 trace of the reference, with the bench loss: a frozen copy of
the ``precision="f64"`` route of ``akbx_torch/trace.py`` as the align
cells run it (a uniform fan, no exit-pupil re-fan, tilt removal by the
mean exit angle, the detector plane at ``s2f_middle + defocus``, the OPL
summed with compensation).  Every function follows the dtype of its
inputs, so the same code runs in float32 for the control.  Plain
PyTorch; imports nothing of the program."""

from __future__ import annotations

from typing import NamedTuple

import torch

from portbench.reference import geometry as geo
from portbench.reference.design import intersect_and_reflect
from portbench.reference.precision import sum_segments


class Result(NamedTuple):
    detcenter: torch.Tensor  # (3, N) focal-plane points, tilt removed
    total_dist: torch.Tensor  # (N,) OPL to the focal plane
    valid: torch.Tensor  # (N,) bool
    exit_dirs: torch.Tensor  # (3, N) exit directions, tilt removed
    # with ``surfaces``: every mirror's points (3, N) and the source (3,)
    # in the frame of the tilt-removed exit beam; else the exit points
    points: tuple
    source: torch.Tensor | None


def masked_mean(x, valid, dim=None):
    w = valid.to(x.dtype)
    if dim is None:
        num, den = torch.sum(x * w), torch.sum(w)
    else:
        num, den = torch.sum(x * w, dim=dim), torch.sum(w, dim=dim)
    return num / torch.clamp_min(den, 1.0)


def linspace(lo, hi, n: int):
    """``lo (1 - s) + hi s`` with ``s = i / (n - 1)``, the last point
    exactly ``hi`` (the program's and numpy's formula)."""
    s = torch.arange(n - 1, dtype=lo.dtype, device=lo.device) / (n - 1)
    return torch.cat([lo * (1 - s) + hi * s, hi.reshape(1)])


def ray_fan(angles_h, angles_v):
    """Direction fan (3, nV*nH), the vertical angle varying slowly."""
    n_h, n_v = angles_h.shape[0], angles_v.shape[0]
    idx = torch.arange(n_h * n_v, device=angles_h.device)
    th = torch.tan(angles_h)[idx % n_h]
    tv = torch.tan(angles_v)[idx // n_h]
    return geo.normalize(torch.stack([torch.ones_like(th), th, tv]))


def detector_points(points, rays, x_plane):
    return geo.plane_intersect(geo.detector_plane(x_plane), rays, points)


def run(system, n: int, defocus, surfaces: bool = False) -> Result:
    """An ``n`` x ``n`` fan through ``system``: trace, remove the mean exit
    tilt about the approximate focus, intersect the focal plane, sum the
    OPL.  ``surfaces``: also turn every mirror's points and the source
    into the exit beam's frame (the wave handoff's geometry)."""
    rays = ray_fan(linspace(system.fan_h[0], system.fan_h[1], n),
                   linspace(system.fan_v[0], system.fan_v[1], n))
    p = system.source[:, None].expand(3, rays.shape[1])
    d = rays
    valid = torch.ones(rays.shape[1], dtype=torch.bool, device=rays.device)
    points, segs = [], []
    for mirror in system.mirrors:
        p, d, _, seg, ok = intersect_and_reflect(mirror, d, p)
        valid = valid & ok
        points.append(p)
        segs.append(seg)
    det_x = system.s2f_middle + defocus
    detcenter = detector_points(p, d, det_x)
    # tilt removal: rotate the exit rays and points about the approximate
    # focus so that the mean exit direction is +x
    theta_y = -masked_mean(torch.atan(d[2] / d[0]), valid)
    theta_z = masked_mean(torch.atan(d[1] / d[0]), valid)
    focus = masked_mean(detcenter, valid[None, :], dim=1)
    d = geo.rotate_vectors_yz(d, -theta_y, -theta_z)
    source = None
    if surfaces:
        points = [geo.rotate_points_about(q, focus, -theta_y, -theta_z)
                  for q in points]
        source = geo.rotate_points_about(system.source[:, None], focus,
                                         -theta_y, -theta_z)[:, 0]
    else:
        points = [geo.rotate_points_about(p, focus, -theta_y, -theta_z)]
    p = points[-1]
    detcenter = detector_points(p, d, det_x)
    d_last = torch.sqrt(torch.sum((detcenter - p) ** 2, dim=0))
    total = sum_segments(segs + [d_last])
    return Result(detcenter, total, valid, d, tuple(points), source)


def spot_size(detcenter, valid):
    """Masked standard deviation of the spot in y and in z."""
    w = valid.to(detcenter.dtype)
    n = torch.clamp_min(torch.sum(w), 1.0)
    mu_y = torch.sum(detcenter[1] * w) / n
    mu_z = torch.sum(detcenter[2] * w) / n
    sy = torch.sqrt(torch.sum(w * (detcenter[1] - mu_y) ** 2) / n)
    sz = torch.sqrt(torch.sum(w * (detcenter[2] - mu_z) ** 2) / n)
    return sy, sz


def demeaned_opl(res: Result):
    return res.total_dist - masked_mean(res.total_dist, res.valid)


def bench_loss(res: Result):
    """The bench loss on the f64 fields: the squared demeaned OPL (in m,
    scaled by 1e18) over the valid rays, plus the spot's two standard
    deviations."""
    w = demeaned_opl(res)
    sy, sz = spot_size(res.detcenter, res.valid)
    return torch.sum(torch.where(res.valid, w, 0.0) ** 2) * 1e18 + sy + sz
