"""Conic design helpers (the part of :mod:`akbx.design` that the system
builders call)."""

from __future__ import annotations

import math

import torch


def _sqrt(v):
    return torch.sqrt(v) if isinstance(v, torch.Tensor) else math.sqrt(v)


def ellipse_y(a, b, x):
    """y on the ellipse at axial position x (focus frame at source)."""
    return torch.sqrt(b**2 - (b * (x - _sqrt(a**2 - b**2)) / a) ** 2)


def hyperbola_y(a, b, x):
    """y on the hyperbola at axial position x (focus frame at source)."""
    return torch.sqrt(-(b**2) + (b * (x - _sqrt(a**2 + b**2)) / a) ** 2)


def wolter_iii_angles(a_hyp, b_hyp, org_hyp, a_ell, b_ell, org_ell, theta1):
    """Layout angles/lengths of a Wolter III (hyperbola-then-ellipse) pair
    in plain f64.  Returns (theta2, theta3, theta4, theta5, l1, l2, l3, l4).
    """
    l2 = (4 * a_hyp**2 + (org_hyp * 2) ** 2
          - 4 * a_hyp * (org_hyp * 2) * torch.cos(theta1)) / (4 * org_hyp - 4 * a_hyp)
    l1 = 2 * a_hyp + l2
    theta2 = torch.asin(org_hyp * 2 * torch.sin(theta1) / l2) / 2
    theta3 = torch.asin(l1 * torch.sin(theta1) / l2)
    l4 = ((org_ell**2 - 2 * org_ell * a_ell * torch.cos(theta3) + a_ell**2)
          / (a_ell - org_ell * torch.cos(theta3)))
    l3 = 2 * a_ell - l2 - l4
    theta5 = torch.asin((2 * a_ell - l4) * torch.sin(theta3) / l4)
    theta4 = torch.asin(2 * org_ell * torch.sin(theta3) / l4) / 2
    return theta2, theta3, theta4, theta5, l1, l2, l3, l4
