"""System builder of the reference for the Wolter III+III tandem AKB:
hyp_V -> ell_V -> hyp_H -> ell_H, both pairs hyperbola then ellipse,
placed in plain f64 (the high-NA design of the reference engine's
``option_wolter_3_3_tandem``, AKB_raytrace_20250312.py:4498-6950).

The placement follows the engine's equations: the canonical conics
shifted along x and given their axial rotation (:4782-4812), the V
pair's layout angle theta5 at both edges of the V hyperbola and the
in-plane rotation omega_V from them (:4906), a chief bundle of three
rays (the chief and the two V edges) traced through the placed mirrors,
the omega rotation of the H hyperbola (:5294-5320) and of the H ellipse
(:5175-5200) about the V ellipse's mean chief centre, then each mirror
misaligned about its own mean chief centre.  Mirror order and the
26-vector ``[defocus, astigH] + 4 x [pitch, roll, yaw, decenterX,
decenterY, decenterZ]`` of hyp_v, hyp_h, ell_v, ell_h are the program's.

Where this module departs from the engine:

* every mirror is placed in plain f64 by 4x4 congruences of its 10
  coefficients (``geometry.shift``, ``geometry.rotate_about_axis``), in
  batches: the four axial turns, the H pair's omega turn and the four
  misalignments, as the program batches them, so that each batched
  product rounds as the program's does; a decenter is one congruence by
  the whole shift vector, where the engine's ``shift_z`` drops the
  ``h -= f*s`` update;
* the decenters move each mirror along its own local axes, and yaw,
  pitch and roll turn it about them in that order, at its centre (the
  independent-mirror path; the engine's Wolter-unit coupling is not
  written here);
* the fan is centred on the mean of the two edge angles of each
  hyperbola, not on theta1, as the engine's traced fan is;
* ``valid`` is the conjunction of every chief intersection's test,
  where the engine returns early on a failed one.

Plain PyTorch; imports nothing of the program."""

from __future__ import annotations

import math

import torch

from portbench.reference import geometry as geo
from portbench.reference.design import (ellipse_coeffs, hyperbola_coeffs,
                                        hyperbola_y, make_mirror)
from portbench.reference.systems import (AKBSpec, AlignParams, OpticalSystem,
                                         _edges_on_conic, _fan)

__all__ = ["AKBSpec", "AlignParams", "build_wolter_3_3_tandem"]

F64 = torch.float64


def wolter_iii_angles(a_hyp, b_hyp, org_hyp, a_ell, b_ell, org_ell, theta1):
    """Layout of a Wolter III pair (hyperbola, then ellipse) from the
    source-side angle ``theta1`` of a ray, in plain f64: (theta2, theta3,
    theta4, theta5, l1, l2, l3, l4); theta5 is the ray's angle after the
    ellipse."""
    l2 = ((4 * a_hyp**2 + (2 * org_hyp) ** 2
           - 4 * a_hyp * (2 * org_hyp) * torch.cos(theta1))
          / (4 * org_hyp - 4 * a_hyp))
    l1 = 2 * a_hyp + l2
    theta2 = torch.asin(2 * org_hyp * torch.sin(theta1) / l2) / 2
    theta3 = torch.asin(l1 * torch.sin(theta1) / l2)
    l4 = ((org_ell**2 - 2 * org_ell * a_ell * torch.cos(theta3) + a_ell**2)
          / (a_ell - org_ell * torch.cos(theta3)))
    l3 = 2 * a_ell - l2 - l4
    theta5 = torch.asin((2 * a_ell - l4) * torch.sin(theta3) / l4)
    theta4 = torch.asin(2 * org_ell * torch.sin(theta3) / l4) / 2
    return theta2, theta3, theta4, theta5, l1, l2, l3, l4


def _hyperbola_edges(a, b, theta1, length, vertical: bool, dev):
    """(x1, y1, x2, y2, ok): the edges of a hyperbola of ``length`` about
    its chief centre at ``theta1``, on the conic with its source focus at
    the origin."""
    c = geo.shift_x(hyperbola_coeffs(a, b, "xz" if vertical else "xy", dev),
                    torch.as_tensor(math.sqrt(a**2 + b**2), dtype=F64,
                                    device=dev))
    return _edges_on_conic(c, theta1, length,
                           lambda x: hyperbola_y(a, b, x), vertical)


def _misalign(coeffs, axes, six, center):
    """yaw, pitch, roll about each mirror's local z, y and x axes through
    its ``center``, then the decenters along those axes; one mirror a
    row of the batch."""
    ax_x, ax_y, ax_z = axes[:, 0], axes[:, 1], axes[:, 2]
    coeffs, _ = geo.rotate_about_axis(coeffs, ax_z, six[:, 2], center)
    coeffs, _ = geo.rotate_about_axis(coeffs, ax_y, six[:, 0], center)
    coeffs, _ = geo.rotate_about_axis(coeffs, ax_x, six[:, 1], center)
    return geo.shift(coeffs, six[:, 3:4] * ax_x + six[:, 4:5] * ax_y
                     + six[:, 5:6] * ax_z)


def build_wolter_3_3_tandem(spec: AKBSpec, params: AlignParams,
                            source_shift=(0.0, 0.0, 0.0)) -> OpticalSystem:
    """Place the four mirrors of a Wolter III+III tandem AKB on the device
    of ``params``.  The spec's H fields are the H pair's hyperbola
    (``a_hyp_h``, ``b_hyp_h``, ``length_hyp_h``) and ellipse (``a_ell_h``,
    ``b_ell_h``)."""
    dev = params.defocus.device
    src_shift = torch.as_tensor(source_shift, dtype=F64, device=dev)
    eye3 = torch.eye(3, dtype=F64, device=dev)
    org_hyp_v, org_ell_v = spec.org_hyp_v, spec.org_ell_v
    org_hyp_h = spec.org_hyp_h
    org_ell_h = math.sqrt(spec.a_ell_h**2 - spec.b_ell_h**2)
    astig = params.astig_h

    # the edges of both hyperbolas, and omega_V from the V pair's layout
    x1_v, y1_v, x2_v, y2_v, ok_v = _hyperbola_edges(
        spec.a_hyp_v, spec.b_hyp_v, spec.theta1_v, spec.length_hyp_v, True,
        dev)
    x1_h, y1_h, x2_h, y2_h, ok_h = _hyperbola_edges(
        spec.a_hyp_h, spec.b_hyp_h, spec.theta1_h, spec.length_hyp_h, False,
        dev)
    th_v1 = torch.atan(y1_v / x1_v)
    th_v2 = torch.atan(y2_v / x2_v)
    t5_v1, t5_v2 = (wolter_iii_angles(
        spec.a_hyp_v, spec.b_hyp_v, org_hyp_v, spec.a_ell_v, spec.b_ell_v,
        org_ell_v, th)[3] for th in (th_v1, th_v2))
    omega_v = (th_v1 + th_v2 + t5_v1 + t5_v2) / 2

    # the four conics, one batch: x shifts (astigH moves the H pair),
    # then the axial turn of each about the origin
    zero3 = torch.zeros((4, 3), dtype=F64, device=dev)
    shifts = torch.stack([
        torch.as_tensor(org_hyp_v, dtype=F64, device=dev),
        torch.as_tensor(2 * org_hyp_v + org_ell_v, dtype=F64, device=dev),
        org_hyp_h + astig, 2 * org_hyp_h + org_ell_h + astig])
    q, R = geo.rotate_about_axis(
        geo.shift_x(torch.stack([
            hyperbola_coeffs(spec.a_hyp_v, spec.b_hyp_v, "xz", dev),
            ellipse_coeffs(spec.a_ell_v, spec.b_ell_v, "xz", dev),
            hyperbola_coeffs(spec.a_hyp_h, spec.b_hyp_h, "xy", dev),
            ellipse_coeffs(spec.a_ell_h, spec.b_ell_h, "xy", dev)]), shifts),
        torch.stack([eye3[1], eye3[1], eye3[2], eye3[2]]),
        torch.tensor([spec.theta1_v, spec.theta1_v, -spec.theta1_h,
                      -spec.theta1_h], dtype=F64, device=dev), zero3)
    hyp_v, ell_v, hyp_h, ell_h = q.unbind(0)
    # local axes as rows: the columns of each turn
    ax1, ax2, ax3, ax4 = R.transpose(-1, -2).unbind(0)

    # the chief bundle: the chief ray and the two V edge rays
    cntr_v = (th_v1 + th_v2) / 2
    one, zero = torch.ones_like(th_v1), torch.zeros_like(th_v1)
    rays = geo.normalize(torch.stack([
        torch.stack([one, zero, zero]),
        torch.stack([one, zero, torch.tan(th_v1 - cntr_v)]),
        torch.stack([one, zero, torch.tan(th_v2 - cntr_v)])], dim=1))
    c_hyp_v, _, ok1 = geo.intersect(hyp_v, rays, torch.zeros_like(rays))
    rays = geo.reflect(rays, geo.surface_normal(hyp_v, c_hyp_v))
    c_ell_v, _, ok2 = geo.intersect(ell_v, rays, c_hyp_v)
    rays = geo.reflect(rays, geo.surface_normal(ell_v, c_ell_v))
    pivot = torch.mean(c_ell_v[:, 1:], dim=1)

    # the H pair turned by omega_V about its local y axes through the
    # pivot, one batch of two; each mirror intersected before and after
    _, _, ok3 = geo.intersect(hyp_h, rays, c_ell_v)
    q, R = geo.rotate_about_axis(
        torch.stack([hyp_h, ell_h]), torch.stack([ax3[1], ax4[1]]),
        omega_v.expand(2), pivot.expand(2, 3))
    ell_h_pre = ell_h
    hyp_h, ell_h = q.unbind(0)
    ax3 = (R[0] @ ax3.T).T
    ax4 = (R[1] @ ax4.T).T
    c_hyp_h, _, ok3b = geo.intersect(hyp_h, rays, c_ell_v)
    rays = geo.reflect(rays, geo.surface_normal(hyp_h, c_hyp_h))
    _, _, ok4 = geo.intersect(ell_h_pre, rays, c_hyp_h)
    c_ell_h, _, ok4b = geo.intersect(ell_h, rays, c_hyp_h)

    valid = ok_v & ok_h
    for ok in (ok1, ok2, ok3, ok3b, ok4, ok4b):
        valid = valid & torch.all(ok)

    # each mirror misaligned about its own mean chief centre, one batch
    centers = torch.stack([torch.mean(c[:, 1:], dim=1)
                           for c in (c_hyp_v, c_ell_v, c_hyp_h, c_ell_h)])
    axes = torch.stack([ax1, ax2, ax3, ax4])
    q = _misalign(torch.stack([hyp_v, ell_v, hyp_h, ell_h]), axes,
                  torch.stack([params.hyp_v, params.ell_v, params.hyp_h,
                               params.ell_h]), centers)
    mirrors = tuple(make_mirror(c, +1.0, m, a) for c, m, a in
                    zip(q.unbind(0), centers.unbind(0), axes.unbind(0)))

    s2f_h = 2 * org_hyp_h + 2 * org_ell_h
    s2f_v = 2 * org_hyp_v + 2 * org_ell_v
    s2f_middle = torch.as_tensor((s2f_h + s2f_v) / 2, dtype=F64, device=dev)
    cntr_h = (torch.atan(y1_h / x1_h) + torch.atan(y2_h / x2_h)) / 2
    fan_h = _fan(y1_h, x1_h, y2_h, x2_h, src_shift[1], src_shift[0], cntr_h)
    fan_v = _fan(y1_v, x1_v, y2_v, x2_v, src_shift[2], src_shift[0], cntr_v)
    return OpticalSystem(mirrors, s2f_middle, fan_h, fan_v, src_shift, valid)
