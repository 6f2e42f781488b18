"""Double-f32 quadric geometry (port of :mod:`akbx.core.geometry_df`):
the arithmetic of the deviation trace :func:`akbx_torch.trace.trace_df`.

Every per-ray quantity is a double-word of float32 (``core.precision``,
~49 bits).  Constants enter as f64 and are split once into f32 pairs.
The 3x3 products (``matvec``, ``quadform``) are elementwise sums of
double-word products, never matmuls, so TF32 cannot reach them.  PyTorch
runs each operator as its own kernel, so nothing contracts across the
error-free transforms.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from akbx_torch.core.precision import (DF, df_add, df_div, df_mul, df_mul_f,
                                       df_neg, df_rsqrt, df_sq, df_sqrt,
                                       df_sub)

F32 = torch.float32
F64 = torch.float64


def split_f64(x, dtype=F32) -> DF:
    """Split an f64 tensor into a double-word of ``dtype`` (hi + lo)."""
    hi = x.to(dtype)
    lo = (x - hi.to(x.dtype)).to(dtype)
    return DF(hi, lo)


def df_to_f64(x: DF) -> torch.Tensor:
    return x.hi.to(F64) + x.lo.to(F64)


def _dot3(ax: DF, ay: DF, az: DF, bx: DF, by: DF, bz: DF) -> DF:
    return df_add(df_add(df_mul(ax, bx), df_mul(ay, by)), df_mul(az, bz))


class Vec3DF(NamedTuple):
    """A 3-vector of double-words, component tensors shaped (N,)."""

    x: DF
    y: DF
    z: DF

    @staticmethod
    def from_f64(arr) -> "Vec3DF":
        return Vec3DF(split_f64(arr[0]), split_f64(arr[1]), split_f64(arr[2]))

    def to_f64(self) -> torch.Tensor:
        return torch.stack([df_to_f64(self.x), df_to_f64(self.y),
                            df_to_f64(self.z)])

    def dot(self, o: "Vec3DF") -> DF:
        return _dot3(self.x, self.y, self.z, o.x, o.y, o.z)

    def scale(self, s: DF) -> "Vec3DF":
        return Vec3DF(df_mul(self.x, s), df_mul(self.y, s), df_mul(self.z, s))

    def add(self, o: "Vec3DF") -> "Vec3DF":
        return Vec3DF(df_add(self.x, o.x), df_add(self.y, o.y),
                      df_add(self.z, o.z))

    def sub(self, o: "Vec3DF") -> "Vec3DF":
        return Vec3DF(df_sub(self.x, o.x), df_sub(self.y, o.y),
                      df_sub(self.z, o.z))

    def shift_const(self, d) -> "Vec3DF":
        """Add a per-component double-word constant (broadcasts)."""
        return Vec3DF(df_add(self.x, d.x), df_add(self.y, d.y),
                      df_add(self.z, d.z))

    def normalize(self) -> "Vec3DF":
        return self.scale(df_rsqrt(self.dot(self)))


def _coeff_df(coeffs):
    """Split a 10-vector of f64 quadric coefficients into df32 scalars."""
    return [split_f64(coeffs[i]) for i in range(10)]


def df_bcast(x: DF, shape) -> DF:
    return DF(x.hi.expand(shape), x.lo.expand(shape))


def vec3_const(v, shape=None) -> Vec3DF:
    """Split an f64 (3,) constant into a Vec3DF (broadcast to ``shape``)."""
    comps = [split_f64(v[i]) for i in range(3)]
    if shape is not None:
        comps = [df_bcast(c, shape) for c in comps]
    return Vec3DF(*comps)


def linform(u: Vec3DF, v: Vec3DF) -> DF:
    """u . v for a (possibly constant) u and per-ray v."""
    return u.dot(v)


def matvec(M9, v: Vec3DF) -> Vec3DF:
    """M @ v with M a 3x3 of pre-split df scalars (tuple of tuples), as
    elementwise sums."""
    rows = []
    for r in range(3):
        m0, m1, m2 = M9[r]
        rows.append(df_add(df_add(df_mul(m0, v.x), df_mul(m1, v.y)),
                           df_mul(m2, v.z)))
    return Vec3DF(*rows)


def mat3_const(M) -> tuple:
    """Split an f64 (3, 3) constant into a 3x3 of df scalars."""
    return tuple(tuple(split_f64(M[r, c]) for c in range(3))
                 for r in range(3))


def quadform(M9, v: Vec3DF) -> DF:
    """v^T M v (per ray)."""
    return linform(matvec(M9, v), v)


def _where(cond, a: DF, b: DF) -> DF:
    return DF(torch.where(cond, a.hi, b.hi), torch.where(cond, a.lo, b.lo))


def _nonzero(x: DF) -> DF:
    """``x`` with a zero hi word replaced by 1 (a safe divisor)."""
    return DF(torch.where(x.hi != 0, x.hi, 1.0), x.lo)


def solve_quadratic_df(A: DF, B: DF, C: DF):
    """Stable q-form roots in double-word arithmetic (the counterpart of
    :func:`akbx_torch.core.geometry.solve_quadratic`): q = -(B + sign(B)
    sqrt(D)) / 2, roots q/A and C/q, D = B^2 - 4AC from exact products.
    Returns ``(t_plus, t_minus, valid)``."""
    D = df_sub(df_sq(B), df_mul_f(df_mul(A, C), 4.0))
    valid = D.hi > 0
    zero = torch.zeros_like(D.hi)
    sqrtD = df_sqrt(DF(torch.where(valid, D.hi, zero),
                       torch.where(valid, D.lo, zero)))
    b_pos = B.hi >= 0
    sgn = torch.where(b_pos, 1.0, -1.0).to(B.hi.dtype)
    q = df_mul_f(df_add(B, df_mul_f(sqrtD, sgn)), -0.5)
    t_q_over_A = df_div(q, _nonzero(A))
    t_C_over_q = df_div(C, _nonzero(q))
    t_plus = _where(b_pos, t_C_over_q, t_q_over_A)
    t_minus = _where(b_pos, t_q_over_A, t_C_over_q)
    return t_plus, t_minus, valid


def intersect_df(coeffs, rays: Vec3DF, origins: Vec3DF, branch):
    """Ray-quadric intersection in df32 (mirror-local coordinates).

    ``coeffs``: f64 10-vector already in the local frame.  Returns
    (points Vec3DF, t DF, valid), with the branch selection and the
    linear fallback for A == 0 of
    :func:`akbx_torch.core.geometry.intersect`.
    """
    a, b, c, d, e, f, g, h, i, j = _coeff_df(coeffs)
    l, m, n = rays.x, rays.y, rays.z
    p, q_, r = origins.x, origins.y, origins.z

    A = df_add(df_add(df_add(df_mul(a, df_sq(l)), df_mul(b, df_sq(m))),
                      df_add(df_mul(c, df_sq(n)), df_mul(d, df_mul(m, l)))),
               df_add(df_mul(e, df_mul(n, l)), df_mul(f, df_mul(m, n))))
    B = df_add(
        df_add(
            df_mul_f(df_add(df_add(df_mul(a, df_mul(p, l)),
                                   df_mul(b, df_mul(q_, m))),
                            df_mul(c, df_mul(r, n))), 2.0),
            df_add(df_mul(d, df_add(df_mul(p, m), df_mul(q_, l))),
                   df_mul(e, df_add(df_mul(p, n), df_mul(r, l))))),
        df_add(df_mul(f, df_add(df_mul(r, m), df_mul(q_, n))),
               df_add(df_add(df_mul(g, l), df_mul(h, m)), df_mul(i, n))))
    C = df_add(
        df_add(df_add(df_mul(a, df_sq(p)), df_mul(b, df_sq(q_))),
               df_add(df_mul(c, df_sq(r)), df_mul(d, df_mul(p, q_)))),
        df_add(df_add(df_mul(e, df_mul(p, r)), df_mul(f, df_mul(q_, r))),
               df_add(df_add(df_mul(g, p), df_mul(h, q_)),
                      df_add(df_mul(i, r), j))))

    t_plus, t_minus, valid = solve_quadratic_df(A, B, C)
    t = _where(torch.as_tensor(branch) >= 0, t_plus, t_minus)

    # linear fallback when A == 0 (a ray along an asymptotic direction)
    t_lin = df_neg(df_div(C, _nonzero(B)))
    is_quad = A.hi != 0
    t = _where(is_quad, t, t_lin)
    valid = torch.where(is_quad, valid, B.hi != 0)
    return origins.add(rays.scale(t)), t, valid


def surface_normal_df(coeffs, points: Vec3DF) -> Vec3DF:
    """Unit gradient of the quadric at df32 points (the convention of
    :func:`akbx_torch.core.geometry.surface_normal`)."""
    a, b, c, d, e, f, g, h, i, _ = _coeff_df(coeffs)
    x, y, z = points.x, points.y, points.z
    nx = df_add(df_add(df_mul_f(df_mul(a, x), 2.0), df_mul(d, y)),
                df_add(df_mul(e, z), g))
    ny = df_add(df_add(df_mul_f(df_mul(b, y), 2.0), df_mul(d, x)),
                df_add(df_mul(f, z), h))
    nz = df_add(df_add(df_mul_f(df_mul(c, z), 2.0), df_mul(e, x)),
                df_add(df_mul(f, y), i))
    return Vec3DF(nx, ny, nz).normalize()


def reflect_df(rays: Vec3DF, normals: Vec3DF) -> Vec3DF:
    """r = d - 2 (d.n) n in double-words (no renormalization)."""
    dot2 = df_mul_f(rays.dot(normals), -2.0)
    return rays.add(normals.scale(dot2))


def plane_x_intersect_df(x_plane_local: DF, rays: Vec3DF, origins: Vec3DF):
    """Intersect with the plane x = const (detector planes); returns
    (points Vec3DF, t DF)."""
    shape = origins.x.hi.shape
    dx = df_sub(df_bcast(x_plane_local, shape), origins.x)
    t = df_div(dx, _nonzero(rays.x))
    return origins.add(rays.scale(t)), t
