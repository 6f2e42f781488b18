"""Double-f64 quadric placement arithmetic (port of
:mod:`akbx.core.quadric_df`).

Placing a mirror evaluates congruence polynomials in offsets of ~73-146 m
on coefficients of ~1e4-1e8, and the Wolter layout angle chain cancels ~8
digits; in plain f64 that costs up to ~3e-8 rad in the in-plane rotation.
So the placement runs in double-word f64 (~32 digits) and rounds to f64
once at the end.

Every transform takes leading batch dimensions: the four per-mirror
placements of :func:`akbx_torch.systems.build_wolter_3_1` run as one
batch of 4.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from akbx_torch.core import geometry as geo
from akbx_torch.core.precision import (DF, df_add, df_div, df_mul, df_mul_f,
                                       df_sqrt, df_sub, two_prod)


class QDF(NamedTuple):
    """A quadric (..., 10) in double-word f64: value = hi + lo (exact)."""

    hi: torch.Tensor
    lo: torch.Tensor

    def to_f64(self) -> torch.Tensor:
        return self.hi + self.lo

    @staticmethod
    def from_f64(coeffs: torch.Tensor) -> "QDF":
        return QDF(coeffs, torch.zeros_like(coeffs))

    @staticmethod
    def stack(qs) -> "QDF":
        """Stack quadrics along a new leading (batch) dimension."""
        return QDF(torch.stack([q.hi for q in qs]),
                   torch.stack([q.lo for q in qs]))

    def unbind(self) -> tuple:
        """Split the leading (batch) dimension into separate quadrics."""
        return tuple(QDF(h, lo) for h, lo in zip(self.hi, self.lo))


def _df(x: torch.Tensor) -> DF:
    return x if isinstance(x, DF) else DF(x, torch.zeros_like(x))


def _quadric_matrix_df(q: QDF) -> DF:
    # gather + exact *0.5 (hi and lo scale exactly)
    return DF(geo.quadric_matrix(q.hi), geo.quadric_matrix(q.lo))


def _matrix_to_coeffs_df(M: DF) -> QDF:
    return QDF(geo.matrix_to_coeffs(M.hi), geo.matrix_to_coeffs(M.lo))


def _df_matmul(A: DF, B: DF) -> DF:
    """(..., 4, 4) DF matrix product with double-word dot products: one
    broadcast df_mul over the (k, i, j) partial-product cube, then a
    pairwise df_add tree over k ((k0+k1) + (k2+k3))."""
    Ak = DF(A.hi.transpose(-1, -2)[..., :, :, None],
            A.lo.transpose(-1, -2)[..., :, :, None])   # (..., k, i, 1)
    Bk = DF(B.hi[..., :, None, :], B.lo[..., :, None, :])  # (..., k, 1, j)
    t = df_mul(Ak, Bk)                                  # (..., 4, 4, 4)
    t = df_add(DF(t.hi[..., 0::2, :, :], t.lo[..., 0::2, :, :]),
               DF(t.hi[..., 1::2, :, :], t.lo[..., 1::2, :, :]))
    return df_add(DF(t.hi[..., 0, :, :], t.lo[..., 0, :, :]),
                  DF(t.hi[..., 1, :, :], t.lo[..., 1, :, :]))


def _congruence_df(M: DF, P: DF) -> DF:
    Pt = DF(P.hi.transpose(-1, -2), P.lo.transpose(-1, -2))
    return _df_matmul(Pt, _df_matmul(M, P))


def _homogeneous_df(R3: torch.Tensor, t_df) -> DF:
    """(..., 4, 4) DF homogeneous matrix from an f64 (..., 3, 3) block and
    a DF translation given as three DF components."""
    hi = geo.homogeneous(R3, torch.stack([t.hi for t in t_df], dim=-1))
    lo = geo.homogeneous(torch.zeros_like(R3),
                         torch.stack([t.lo for t in t_df], dim=-1), corner=0.0)
    return DF(hi, lo)


def shift(q: QDF, t: torch.Tensor) -> QDF:
    """Translate the surface by ``t`` (..., 3) in double-word."""
    eye = torch.eye(3, dtype=t.dtype, device=t.device).expand(
        *t.shape[:-1], 3, 3)
    P = _homogeneous_df(eye, [_df(-t[..., i]) for i in range(3)])
    return _matrix_to_coeffs_df(_congruence_df(_quadric_matrix_df(q), P))


def shift_x(q: QDF, s: torch.Tensor) -> QDF:
    z = torch.zeros_like(s)
    return shift(q, torch.stack([s, z, z], dim=-1))


def transform(q: QDF, R: torch.Tensor, center: torch.Tensor) -> QDF:
    """Rotate the surface by ``R`` about ``center``; the translation column
    t = c - R^T c is computed in double-word (the ~theta*|c| cancellation
    at |c| ~ 146 m)."""
    c = center
    Rt = R.transpose(-1, -2)
    t_df = []
    for i in range(3):
        acc = two_prod(-Rt[..., i, 0], c[..., 0])
        acc = df_add(acc, two_prod(-Rt[..., i, 1], c[..., 1]))
        acc = df_add(acc, two_prod(-Rt[..., i, 2], c[..., 2]))
        acc = df_add(acc, _df(c[..., i]))
        t_df.append(acc)
    P = _homogeneous_df(Rt, t_df)
    return _matrix_to_coeffs_df(_congruence_df(_quadric_matrix_df(q), P))


def rotate_about_axis(q: QDF, axis, theta, center):
    """DF counterpart of geometry.rotate_about_axis: returns (QDF, R)."""
    R = geo.rodrigues(axis, theta)
    return transform(q, R, center), R


# --- double-word trig for the layout angle chains ------------------------
# Inputs are placement-time angles with |x| < pi/4, so the Taylor series
# converge to the full ~32 digits in 13 terms.

_N_TERMS = 13


def _df_horner_trig(x2: DF, denoms) -> DF:
    """acc_k = (1 - acc_{k+1}) * x^2 / denom_k, folded from k = n..1."""
    one = _df(torch.ones_like(x2.hi))
    acc = DF(torch.zeros_like(x2.hi), torch.zeros_like(x2.lo))
    for denom in denoms:
        acc = df_mul(df_sub(one, acc), DF(x2.hi / denom, x2.lo / denom))
    return acc


def df_sin_small(x: DF) -> DF:
    """sin(x) in double-word for |x| < ~0.8 (Taylor)."""
    x2 = df_mul(x, x)
    acc = _df_horner_trig(x2, [float((2 * k) * (2 * k + 1))
                               for k in range(_N_TERMS, 0, -1)])
    return df_mul(x, df_sub(_df(torch.ones_like(x.hi)), acc))


def df_cos_small(x: DF) -> DF:
    """cos(x) in double-word for |x| < ~0.8 (Taylor)."""
    x2 = df_mul(x, x)
    acc = _df_horner_trig(x2, [float((2 * k - 1) * (2 * k))
                               for k in range(_N_TERMS, 0, -1)])
    return df_sub(_df(torch.ones_like(x.hi)), acc)


def df_asin(x: DF) -> DF:
    """arcsin(x) in double-word via one Newton step on df_sin_small
    (|x| <~ 0.7): y1 = y0 + (x - sin y0) / cos y0, y0 the f64 arcsin."""
    y0df = _df(torch.asin(x.hi))
    r = df_sub(x, df_sin_small(y0df))
    return df_add(y0df, df_div(r, df_cos_small(y0df)))


def wolter_iii_angles_df(a_hyp, b_hyp, a_ell, b_ell, theta1: torch.Tensor):
    """The Wolter III layout angle chain in double-word f64 (same algebra
    as :func:`akbx_torch.design.wolter_iii_angles`, with the conic origins
    recomputed in DF so ``org - a = b^2/(org + a)`` keeps its digits).

    ``theta1`` may carry batch dimensions.  Returns (theta2, theta3,
    theta4, theta5) as DF."""

    def const(v):
        return _df(torch.full_like(theta1, float(v)))

    a_h, b_h, a_e, b_e = const(a_hyp), const(b_hyp), const(a_ell), const(b_ell)
    th1 = _df(theta1)

    a2_h = df_mul(a_h, a_h)
    o2_h = df_add(a2_h, df_mul(b_h, b_h))      # org_hyp^2 = a^2 + b^2
    org_h = df_sqrt(o2_h)
    a2_e = df_mul(a_e, a_e)
    o2_e = df_sub(a2_e, df_mul(b_e, b_e))      # org_ell^2 = a^2 - b^2
    org_e = df_sqrt(o2_e)

    c1 = df_cos_small(th1)
    s1 = df_sin_small(th1)

    # l2 = (4 a^2 + 4 org^2 - 8 a org cos th1) / (4 org - 4 a)
    num = df_sub(df_add(a2_h, o2_h), df_mul_f(df_mul(df_mul(a_h, org_h), c1),
                                              2.0))
    l2 = df_div(num, df_sub(org_h, a_h))
    l1 = df_add(df_mul_f(a_h, 2.0), l2)
    theta2 = df_mul_f(
        df_asin(df_div(df_mul(df_mul_f(org_h, 2.0), s1), l2)), 0.5)
    theta3 = df_asin(df_div(df_mul(l1, s1), l2))

    c3 = df_cos_small(theta3)
    s3 = df_sin_small(theta3)
    # l4 = (org_e^2 - 2 org_e a_ell cos th3 + a_ell^2) / (a_ell - org_e cos th3)
    num4 = df_sub(df_add(o2_e, a2_e),
                  df_mul_f(df_mul(df_mul(org_e, a_e), c3), 2.0))
    l4 = df_div(num4, df_sub(a_e, df_mul(org_e, c3)))
    theta5 = df_asin(df_div(df_mul(df_sub(df_mul_f(a_e, 2.0), l4), s3), l4))
    theta4 = df_mul_f(
        df_asin(df_div(df_mul(df_mul_f(org_e, 2.0), s3), l4)), 0.5)
    return theta2, theta3, theta4, theta5
