"""Double-word arithmetic of the reference: a frozen copy of
``akbx_torch/core/precision.py`` (the error-free transforms and the
double-word ops that the double-f64 placement and the compensated OPL
sum use).  Plain PyTorch; imports nothing of the program."""

from __future__ import annotations

from typing import NamedTuple

import torch


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
    otherwise be rounded to the wrong precision inside the EFTs)."""
    return torch.as_tensor(y, dtype=x.dtype, device=x.device)


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
