"""Quadric geometry core (port of :mod:`akbx.core.geometry`).

A mirror surface is the zero set of the 10-coefficient quadric

    S(x, y, z) = a x^2 + b y^2 + c z^2 + d xy + e xz + f yz + g x + h y + i z + j

stored as ``coeffs = [a..j]``.  Rays and points are ``(3, N)`` tensors.
The coefficient transforms (``quadric_matrix`` .. ``rotate_about_axis``)
take any leading batch dimensions, so several mirrors are placed in one
call; the ray functions take one ``(10,)`` quadric.
"""

from __future__ import annotations

import torch

from akbx_torch.utils import constant, linspace

# (4, 4) gather of the 10-vector into the symmetric homogeneous matrix,
# and the factor of each entry (off-diagonal entries carry half a coeff)
QUADRIC_IDX = ((0, 3, 4, 6), (3, 1, 5, 7), (4, 5, 2, 8), (6, 7, 8, 9))
QUADRIC_HALF = ((1.0, 0.5, 0.5, 0.5), (0.5, 1.0, 0.5, 0.5),
                (0.5, 0.5, 1.0, 0.5), (0.5, 0.5, 0.5, 1.0))
# matrix entries of the 10-vector, and their factor
COEFF_ROWS = (0, 1, 2, 0, 0, 1, 0, 1, 2, 3)
COEFF_COLS = (0, 1, 2, 1, 2, 2, 3, 3, 3, 3)
COEFF_SCALE = (1.0, 1.0, 1.0, 2.0, 2.0, 2.0, 2.0, 2.0, 2.0, 1.0)


def normalize(v: torch.Tensor, dim: int = 0, eps: float = 0.0) -> torch.Tensor:
    """Normalize vectors along ``dim``; zero vectors pass through unchanged."""
    norm = torch.sqrt(torch.sum(v * v, dim=dim, keepdim=True))
    safe = torch.where(norm > eps, norm, 1.0)
    return v / safe


def quadric_eval(coeffs: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Evaluate S(x, y, z) of one (10,) quadric at points (3, N) -> (N,)."""
    a, b, c, d, e, f, g, h, i, j = coeffs.unbind(-1)
    x, y, z = points
    return (
        a * x * x + b * y * y + c * z * z
        + d * x * y + e * x * z + f * y * z
        + g * x + h * y + i * z + j
    )


def quadric_matrix(coeffs: torch.Tensor) -> torch.Tensor:
    """(..., 10) -> symmetric homogeneous (..., 4, 4) with [x,1]^T M [x,1] = S."""
    idx = constant(QUADRIC_IDX, coeffs, torch.long)
    return coeffs[..., idx] * constant(QUADRIC_HALF, coeffs)


def matrix_to_coeffs(M: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) -> (..., 10), the inverse of :func:`quadric_matrix`."""
    rows = constant(COEFF_ROWS, M, torch.long)
    cols = constant(COEFF_COLS, M, torch.long)
    return M[..., rows, cols] * constant(COEFF_SCALE, M)


def homogeneous(R3: torch.Tensor, t: torch.Tensor,
                corner: float = 1.0) -> torch.Tensor:
    """(..., 4, 4) homogeneous matrix from a (..., 3, 3) block and a (..., 3)
    translation column (``corner`` 0 gives the lo word of a DF matrix)."""
    top = torch.cat([R3, t[..., :, None]], dim=-1)
    bottom = constant((0.0, 0.0, 0.0, corner), R3).expand(
        *R3.shape[:-2], 1, 4)
    return torch.cat([top, bottom], dim=-2)


def _eye3(like: torch.Tensor, batch=()) -> torch.Tensor:
    return constant(((1.0, 0.0, 0.0), (0.0, 1.0, 0.0), (0.0, 0.0, 1.0)),
                    like).expand(*batch, 3, 3)


def _transform_matrix(M: torch.Tensor, P: torch.Tensor) -> torch.Tensor:
    """Congruence M' = P^T M P (P maps new-frame homogeneous coords to old)."""
    return P.transpose(-1, -2) @ M @ P


def shift(coeffs: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Translate the surface by ``t`` (..., 3): the surface moves by +t."""
    P = homogeneous(_eye3(t, t.shape[:-1]), -t)
    return matrix_to_coeffs(_transform_matrix(quadric_matrix(coeffs), P))


def _axis_vector(s: torch.Tensor, k: int) -> torch.Tensor:
    z = torch.zeros_like(s)
    return torch.stack([s if i == k else z for i in range(3)], dim=-1)


def shift_x(coeffs, s):
    return shift(coeffs, _axis_vector(s, 0))


def shift_y(coeffs, s):
    return shift(coeffs, _axis_vector(s, 1))


def shift_z(coeffs, s):
    return shift(coeffs, _axis_vector(s, 2))


def rodrigues(axis: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) about ``axis`` (..., 3) by ``theta`` (...)."""
    axis = axis / torch.sqrt(torch.sum(axis * axis, dim=-1, keepdim=True))
    ux, uy, uz = axis.unbind(-1)
    z = torch.zeros_like(ux)
    K = torch.stack([torch.stack([z, -uz, uy], -1),
                     torch.stack([uz, z, -ux], -1),
                     torch.stack([-uy, ux, z], -1)], -2)
    c = torch.cos(theta)[..., None, None]
    s = torch.sin(theta)[..., None, None]
    outer = axis[..., :, None] * axis[..., None, :]
    return c * _eye3(axis, axis.shape[:-1]) + (1.0 - c) * outer + s * K


def transform_quadric(coeffs: torch.Tensor, R: torch.Tensor | None = None,
                      center: torch.Tensor | None = None) -> torch.Tensor:
    """Rotate the surface by ``R`` about ``center`` (active rotation):
    points on the new surface satisfy x_new = R (x_old - c) + c."""
    M = quadric_matrix(coeffs)
    if R is None:
        return matrix_to_coeffs(M)
    c = torch.zeros_like(R[..., 0]) if center is None else center
    Rt = R.transpose(-1, -2)
    # inverse map: x_old = R^T (x_new - c) + c
    P = homogeneous(Rt, c - (Rt @ c[..., None])[..., 0])
    return matrix_to_coeffs(_transform_matrix(M, P))


def rotate_about_axis(coeffs, axis, theta, center):
    """Rotate the surface about ``axis`` through ``center``; returns
    ``(new_coeffs, R)``."""
    R = rodrigues(axis, theta)
    return transform_quadric(coeffs, R, center), R


def rotate_x(coeffs, theta, center):
    """Rotate the surface about the global x axis through ``center``."""
    return rotate_about_axis(coeffs, constant((1.0, 0.0, 0.0), coeffs),
                             theta, center)[0]


def rotate_y(coeffs, theta, center):
    """Rotate the surface about the global y axis through ``center``."""
    return rotate_about_axis(coeffs, constant((0.0, 1.0, 0.0), coeffs),
                             theta, center)[0]


def rotate_z(coeffs, theta, center):
    """Rotate the surface about the global z axis through ``center``."""
    return rotate_about_axis(coeffs, constant((0.0, 0.0, 1.0), coeffs),
                             theta, center)[0]


def solve_quadratic(A, B, C):
    """Stable roots of ``A t^2 + B t + C = 0`` (q-form); returns
    ``(t_plus, t_minus, valid)`` with ``valid`` flagging ``D > 0``."""
    D = B * B - 4 * A * C
    valid = D > 0
    sqrtD = torch.sqrt(torch.where(valid, D, 0.0))
    sgn = torch.where(B >= 0, constant(1.0, B), constant(-1.0, B))
    qq = -0.5 * (B + sgn * sqrtD)
    safe_A = torch.where(A != 0, A, 1.0)
    safe_q = torch.where(qq != 0, qq, 1.0)
    t_q_over_A = qq / safe_A
    t_C_over_q = C / safe_q
    t_plus = torch.where(B >= 0, t_C_over_q, t_q_over_A)
    t_minus = torch.where(B >= 0, t_q_over_A, t_C_over_q)
    return t_plus, t_minus, valid


def intersect(coeffs: torch.Tensor, rays: torch.Tensor, origins: torch.Tensor,
              branch=+1):
    """Ray-quadric intersection; returns ``(points (3,N), t (N,), valid)``.

    ``branch >= 0`` selects the ``(-B + sqrt(D))`` root, else the
    ``(-B - sqrt(D))`` root (the reference's ``negative=`` flag)."""
    a, b, c, d, e, f, g, h, i, j = coeffs.unbind(-1)
    l, m, n = rays
    p, q_, r = origins

    A = a * l * l + b * m * m + c * n * n + d * m * l + e * n * l + f * m * n
    B = (
        2 * a * p * l + 2 * b * q_ * m + 2 * c * r * n
        + d * (p * m + q_ * l) + e * (p * n + r * l) + f * (r * m + q_ * n)
        + g * l + h * m + i * n
    )
    C = (
        a * p * p + b * q_ * q_ + c * r * r
        + d * p * q_ + e * p * r + f * q_ * r
        + g * p + h * q_ + i * r + j
    )

    t_plus, t_minus, valid = solve_quadratic(A, B, C)
    if not isinstance(branch, torch.Tensor):
        branch = constant(float(branch), A)
    t = torch.where(branch >= 0, t_plus, t_minus)

    # degenerate A == 0: the linear equation B t + C = 0
    t_lin = -C / torch.where(B != 0, B, 1.0)
    is_quad = A != 0
    t = torch.where(is_quad, t, t_lin)
    valid = torch.where(is_quad, valid, B != 0)

    points = origins + t * rays
    return points, t, valid


def surface_normal(coeffs: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Unit outward gradient of the quadric at ``points`` (3, N)."""
    a, b, c, d, e, f, g, h, i, _ = coeffs.unbind(-1)
    x, y, z = points
    N = torch.stack([
        2 * a * x + d * y + e * z + g,
        2 * b * y + d * x + f * z + h,
        2 * c * z + e * x + f * y + i,
    ])
    return normalize(N)


def reflect(rays: torch.Tensor, normals: torch.Tensor,
            renormalize: bool = True) -> torch.Tensor:
    """Specular reflection ``r = d - 2 (d.n) n``."""
    dot = torch.sum(rays * normals, dim=0)
    r = rays - 2 * dot * normals
    return normalize(r) if renormalize else r


def plane_intersect(coeffs: torch.Tensor, rays: torch.Tensor,
                    origins: torch.Tensor) -> torch.Tensor:
    """Ray-plane intersection; the plane ``g x + h y + i z + j = 0`` is
    ``coeffs[6:10]``."""
    g, h, i, j = coeffs[6], coeffs[7], coeffs[8], coeffs[9]
    l, m, n = rays
    p, q, r = origins
    denom = g * l + h * m + i * n
    t = -(g * p + h * q + i * r + j) / torch.where(denom != 0, denom, 1.0)
    return origins + t * rays


def detector_plane(x_position: torch.Tensor) -> torch.Tensor:
    """The plane ``x = x_position`` as a 10-coeff quadric."""
    z = torch.zeros_like(x_position)
    return torch.stack([z, z, z, z, z, z, torch.ones_like(x_position), z, z,
                        -x_position])


def rotate_vectors_yz(vectors: torch.Tensor, theta_y, theta_z) -> torch.Tensor:
    """Apply R_y(theta_y) @ R_z(theta_z) (z first, then y) to (3, N)."""
    ey = constant((0.0, 1.0, 0.0), vectors)
    ez = constant((0.0, 0.0, 1.0), vectors)
    return rodrigues(ey, theta_y) @ (rodrigues(ez, theta_z) @ vectors)


def rotate_points_about(points: torch.Tensor, pivot: torch.Tensor,
                        theta_y, theta_z) -> torch.Tensor:
    """Rotate points (3, N) about ``pivot`` with :func:`rotate_vectors_yz`."""
    c = pivot.reshape(3, 1)
    return rotate_vectors_yz(points - c, theta_y, theta_z) + c


def tangent(coeffs: torch.Tensor, rays: torch.Tensor,
            points: torch.Tensor) -> torch.Tensor:
    """In-surface tangent: the ray minus its normal component."""
    N = surface_normal(coeffs, points)
    dot = torch.sum(rays * N, dim=0)
    return normalize(rays - dot * N)


def curvature(coeffs: torch.Tensor, rays: torch.Tensor,
              points: torch.Tensor) -> torch.Tensor:
    """The quadric's Hessian as a quadratic form along the tangent,
    ``v^T H v`` (N,)."""
    a, b, c, d, e, f = coeffs[:6].unbind(-1)
    H = torch.stack([torch.stack([2 * a, d, e]), torch.stack([d, 2 * b, f]),
                     torch.stack([e, f, 2 * c])])
    v = tangent(coeffs, rays, points)
    return torch.einsum("iN,ij,jN->N", v, H, v)


def rotate_points(points: torch.Tensor, R: torch.Tensor,
                  center: torch.Tensor | None = None) -> torch.Tensor:
    """Rotate a point batch (3, N) by ``R`` about ``center``."""
    if center is None:
        return R @ points
    c = center.reshape(3, 1)
    return R @ (points - c) + c


def _point_rotate(points, theta, center, axis):
    theta = torch.as_tensor(theta, dtype=points.dtype, device=points.device)
    center = torch.as_tensor(center, dtype=points.dtype, device=points.device)
    return rotate_points(points, rodrigues(constant(axis, points), -theta),
                         center)


def point_rotate_x(points, theta, center):
    """Rotate points about the x axis through ``center`` by ``-theta`` (the
    reference's sign convention)."""
    return _point_rotate(points, theta, center, (1.0, 0.0, 0.0))


def point_rotate_y(points, theta, center):
    """Rotate points about the y axis through ``center`` by ``-theta``."""
    return _point_rotate(points, theta, center, (0.0, 1.0, 0.0))


def point_rotate_z(points, theta, center):
    """Rotate points about the z axis through ``center`` by ``-theta``."""
    return _point_rotate(points, theta, center, (0.0, 0.0, 1.0))


def grid_on_mirror(coeffs: torch.Tensor, corners: torch.Tensor,
                   n_h: int, n_v: int) -> torch.Tensor:
    """Bilinear (n_v, n_h) grid between 4 corner points (3, 4), projected
    onto the quadric along -x; returns (3, n_v * n_h)."""
    p1, p2, p3, p4 = corners.T
    u = linspace(0.0, 1.0, n_h, like=corners)
    v = linspace(0.0, 1.0, n_v, like=corners)
    vv, uu = torch.meshgrid(v, u, indexing="ij")  # (n_v, n_h)
    w = (
        (1 - uu) * (1 - vv) * p1[:, None, None]
        + uu * (1 - vv) * p2[:, None, None]
        + uu * vv * p3[:, None, None]
        + (1 - uu) * vv * p4[:, None, None]
    ).reshape(3, -1)
    ray = constant((-1.0, 0.0, 0.0), corners)[:, None].expand(w.shape)
    return intersect(coeffs, ray, w)[0]
