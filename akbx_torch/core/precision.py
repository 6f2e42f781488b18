"""Compensated / double-word arithmetic (port of :mod:`akbx.core.precision`).

A double-word ("df") number is an unevaluated sum ``hi + lo`` with
``|lo| <= ulp(hi)/2``: an f32 pair carries ~49 mantissa bits, an f64 pair
~106.  Every function here is generic over float32 and float64 tensors.

The error-free transforms (EFTs) are exact only if every add and multiply
rounds exactly as written.  PyTorch eager runs each operator as its own
kernel, so there is no algebraic folding and no FMA contraction between
operators: the EFTs need no value barriers.

``two_prod`` has two forms.  For float32 it is the FMA form, ``p = a b``
and ``e = fma(a, b, -p)``, which the CUDA kernels of
:mod:`akbx_torch.kernels` run as ``__fmul_rn`` and ``__fmaf_rn``
(``csrc/df32.cuh``); here the FMA is taken through float64, where the
48-bit product of two float32 values is exact.  It gives the same
``(p, e)`` as the Dekker form of the JAX package bit for bit wherever
every partial product of that form is a normal float32.  Below that
(``|a b|`` under about 2^-102 in IEEE arithmetic, under about 2^-78 where
subnormals are flushed, as XLA does on the CPU) the FMA form stays exact
up to one rounding of a subnormal error term and the Dekker form does
not; in IEEE arithmetic the two then differ by at most 2^-148
(``tests/test_torch_two_prod.py``).  For float64, the double-f64 placement of
:mod:`akbx_torch.core.quadric_df`, there is no wider type, and the
contraction-immune Dekker form of the JAX package stays.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from akbx_torch.utils import constant

# Dekker split constant 2^s + 1, s = ceil(mantissa_bits / 2)
_SPLIT_C = {torch.float32: 4097.0, torch.float64: 134217729.0}


class DF(NamedTuple):
    """Double-word float: represents hi + lo exactly (unevaluated sum)."""

    hi: torch.Tensor
    lo: torch.Tensor


def two_sum(a, b) -> DF:
    """Error-free addition: a + b = s + e exactly (Knuth)."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return DF(s, e)


def fast_two_sum(a, b) -> DF:
    """Error-free addition assuming |a| >= |b| (Dekker)."""
    s = a + b
    return DF(s, b - (s - a))


def _split(a):
    """Dekker split of a float tensor into high/low halves."""
    t = _SPLIT_C[a.dtype] * a
    hi = t - (t - a)
    return hi, a - hi


def two_prod(a, b) -> DF:
    """Error-free multiplication a * b = p + e.

    float32: ``p = a b`` rounded, ``e = fma(a, b, -p)``.  The product of
    two 24-bit mantissas has 48 bits and is exact in float64, so is its
    difference from ``p``; the conversion back rounds only a subnormal
    error term, once, as ``fmaf`` does.  float64: the Dekker form of
    :func:`akbx.core.precision.two_prod`, four exactly representable
    partial products assembled with ``two_sum`` chains."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        p = a * b
        return DF(p, (a.double() * b.double() - p.double()).float())
    ah, al = _split(a)
    bh, bl = _split(b)
    hh = ah * bh
    hl = ah * bl
    lh = al * bh
    ll = al * bl
    c = two_sum(hl, lh)
    p = two_sum(hh, c.hi)
    d = two_sum(p.lo, c.lo)
    q = two_sum(d.hi, ll)
    r = fast_two_sum(p.hi, q.hi)
    s = two_sum(d.lo, q.lo)
    t = two_sum(r.lo, s.hi)
    lo = t.hi + (t.lo + s.lo)
    return fast_two_sum(r.hi, lo)


def df_from(a) -> DF:
    return DF(a, torch.zeros_like(a))


def _like(y, x):
    """``y`` as a tensor of ``x``'s dtype and device (a Python float would
    otherwise be rounded to the wrong precision inside the EFTs; a number
    from the shared constants of :func:`akbx_torch.utils.constant`)."""
    if isinstance(y, torch.Tensor):
        return torch.as_tensor(y, dtype=x.dtype, device=x.device)
    return constant(float(y), x)


def df_add(x: DF, y: DF) -> DF:
    s = two_sum(x.hi, y.hi)
    t = two_sum(x.lo, y.lo)
    c = s.lo + t.hi
    v = fast_two_sum(s.hi, c)
    w = t.lo + v.lo
    return fast_two_sum(v.hi, w)


def df_add_f(x: DF, y) -> DF:
    y = _like(y, x.hi)
    s = two_sum(x.hi, y)
    v = s.lo + x.lo
    return fast_two_sum(s.hi, v)


def df_neg(x: DF) -> DF:
    return DF(-x.hi, -x.lo)


def df_sub(x: DF, y: DF) -> DF:
    return df_add(x, df_neg(y))


def df_mul(x: DF, y: DF) -> DF:
    p = two_prod(x.hi, y.hi)
    e = p.lo + (x.hi * y.lo + x.lo * y.hi)
    return fast_two_sum(p.hi, e)


def df_mul_f(x: DF, y) -> DF:
    y = _like(y, x.hi)
    p = two_prod(x.hi, y)
    e = p.lo + x.lo * y
    return fast_two_sum(p.hi, e)


def df_sq(x: DF) -> DF:
    return df_mul(x, x)


def df_div(x: DF, y: DF) -> DF:
    """Double-word division: quotient + one Newton-style correction."""
    safe = torch.where(y.hi != 0, y.hi, 1.0)
    q1 = x.hi / safe
    r = df_sub(x, df_mul_f(y, q1))
    q2 = (r.hi + r.lo) / safe
    return fast_two_sum(q1, q2)


def df_rsqrt(x: DF) -> DF:
    """Double-word reciprocal square root: 1/sqrt(x)."""
    s = torch.sqrt(torch.where(x.hi > 0, x.hi, 1.0))
    r0 = 1.0 / s
    # one double-word Newton step: r = r0 * (3 - x r0^2) / 2
    r0df = df_from(r0)
    xr2 = df_mul(x, df_sq(r0df))
    corr = df_mul_f(df_add_f(df_neg(xr2), 3.0), 0.5)
    return df_mul(r0df, corr)


def df_sqrt(x: DF) -> DF:
    """Double-word sqrt via one Newton refinement of the base sqrt."""
    s = torch.sqrt(x.hi)
    s2 = two_prod(s, s)
    d = two_sum(x.hi, -s2.hi)
    r = d.hi + (d.lo - s2.lo + x.lo)
    safe = torch.where(s > 0, s, 1.0)
    e = r / (2.0 * safe)
    return fast_two_sum(s, e)


def df_to_float(x: DF):
    return x.hi + x.lo


def sum_segments(segments) -> torch.Tensor:
    """Compensated per-ray sum of a short list of segment-length tensors."""
    acc = df_from(segments[0])
    for s in segments[1:]:
        acc = df_add_f(acc, s)
    return df_to_float(acc)


def dot3_df(ax, ay, az, bx, by, bz) -> DF:
    """Error-compensated 3-vector dot product."""
    s = df_add(two_prod(ax, bx), two_prod(ay, by))
    return df_add(s, two_prod(az, bz))


def norm3_df(x, y, z) -> DF:
    """Error-compensated Euclidean norm of a 3-vector."""
    return df_sqrt(dot3_df(x, y, z, x, y, z))


def kahan_sum(terms: torch.Tensor, axis=None):
    """Compensated sum of every element of ``terms`` (a short list of
    segment lengths, folded with ``two_sum``).  Per-ray sums take
    :func:`sum_segments`."""
    if axis is not None:
        raise NotImplementedError("use sum_segments for per-ray segment sums")
    flat = terms.reshape(-1)
    acc = df_from(flat[0])
    for k in range(1, flat.shape[0]):
        acc = df_add_f(acc, flat[k])
    return df_to_float(acc)


def stable_sqrt_diff(d2: torch.Tensor, r_ref: torch.Tensor) -> torch.Tensor:
    """Cancellation-free ``sqrt(d2) - r_ref`` given ``r_ref ~ sqrt(d2)``:
    ``(d2 - r_ref^2) / (sqrt(d2) + r_ref)``."""
    r = torch.sqrt(d2)
    return (d2 - r_ref * r_ref) / (r + r_ref)
