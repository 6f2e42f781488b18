"""The Wolter III+I AKB system builder (port of the first half of
:mod:`akbx.systems`).

``build_wolter_3_1`` places the four mirrors: canonical conics -> axial
shifts and rotations -> chief-ray pre-trace -> in-plane rotation by
omega_V -> per-mirror misalignment from the 26-vector
``[defocus, astigH] + 4 x [pitch, roll, yaw, decenterX, decenterY,
decenterZ]`` (mirror order hyp_v, hyp_h, ell_v, ell_h).  The four
per-mirror placements run as one batch of 4 where the JAX package vmaps.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from akbx_torch import design, device_of
from akbx_torch.core import geometry as geo
from akbx_torch.core import quadric_df as qdf
from akbx_torch.surfaces import (ellipse_coeffs, hyperbola_coeffs,
                                 make_mirror)

F64 = torch.float64


class AlignParams(NamedTuple):
    """The 26 alignment degrees of freedom (reference params vector)."""

    defocus: torch.Tensor
    astig_h: torch.Tensor
    # per mirror: pitch, roll, yaw, dx, dy, dz
    hyp_v: torch.Tensor  # (6,)
    hyp_h: torch.Tensor  # (6,)
    ell_v: torch.Tensor  # (6,)
    ell_h: torch.Tensor  # (6,)

    @staticmethod
    def from_vector(v, device=None) -> "AlignParams":
        """From a 26-vector; a tensor keeps its device, anything else goes
        to ``device`` or the card (:func:`akbx_torch.default_device`)."""
        v = torch.as_tensor(v, dtype=F64, device=device_of(v, device))
        return AlignParams(v[0], v[1], v[2:8], v[8:14], v[14:20], v[20:26])

    def to_vector(self) -> torch.Tensor:
        return torch.cat([torch.stack([self.defocus, self.astig_h]),
                          self.hyp_v, self.hyp_h, self.ell_v, self.ell_h])

    @staticmethod
    def zeros(device=None) -> "AlignParams":
        return AlignParams.from_vector(
            torch.zeros(26, dtype=F64, device=device_of(None, device)))


@dataclasses.dataclass(frozen=True)
class AKBSpec:
    """Mirror design constants of a Wolter III+I AKB system.

    V pair = Wolter III (hyperbola then ellipse, deflecting z);
    H pair = Wolter I (ellipse then hyperbola, deflecting y).
    """

    a_hyp_v: float
    b_hyp_v: float
    a_ell_v: float
    b_ell_v: float
    length_hyp_v: float
    length_ell_v: float
    theta1_v: float
    a_ell_h: float
    b_ell_h: float
    a_hyp_h: float
    b_hyp_h: float
    length_hyp_h: float
    length_ell_h: float
    theta1_h: float

    @property
    def org_hyp_v(self):
        return math.sqrt(self.a_hyp_v**2 + self.b_hyp_v**2)

    @property
    def org_ell_v(self):
        return math.sqrt(self.a_ell_v**2 - self.b_ell_v**2)

    @property
    def org_ell_h(self):
        return math.sqrt(self.a_ell_h**2 - self.b_ell_h**2)

    @property
    def org_hyp_h(self):
        return math.sqrt(self.a_hyp_h**2 + self.b_hyp_h**2)


# The reference's active EUV design data ("3型 Setting12" + "1型 setting11").
WOLTER_3_1_DEFAULT = AKBSpec(
    a_hyp_v=72.9825, b_hyp_v=0.263879113520857,
    a_ell_v=0.1175, b_ell_v=0.0283168369674688,
    length_hyp_v=0.043, length_ell_v=0.0809220387326922,
    theta1_v=5.55983241203018e-05,
    a_ell_h=73.1076714403445, b_ell_h=0.517019631143022,
    a_hyp_h=0.0077, b_hyp_h=0.00432051448679384,
    length_hyp_h=0.01380360633, length_ell_h=0.030,
    theta1_h=0.000145746388538841,
)


class OpticalSystem(NamedTuple):
    """A placed, misaligned mirror chain ready for tracing."""

    mirrors: tuple  # Mirror, in reflection order
    s2f_middle: torch.Tensor  # nominal source->focus distance along x
    fan_h: torch.Tensor  # (2,) source-fan angle range, horizontal (y)
    fan_v: torch.Tensor  # (2,) source-fan angle range, vertical (z)
    source: torch.Tensor  # (3,) source position
    valid: torch.Tensor  # geometry validity flag (bool)


def _edges_on_conic(coeffs, theta1, length, y_of_x, vertical: bool):
    """Chief-ray center + mirror edge coordinates on a canonical conic."""
    th = torch.as_tensor(theta1, dtype=F64, device=coeffs.device)
    z = torch.zeros_like(th)
    d = torch.stack([torch.cos(th), z, torch.sin(th)] if vertical
                    else [torch.cos(th), torch.sin(th), z])[:, None]
    center, _, ok = geo.intersect(coeffs, d, torch.zeros_like(d))
    x1 = center[0, 0] - length / 2
    x2 = center[0, 0] + length / 2
    return x1, y_of_x(x1), x2, y_of_x(x2), ok[0]


def _apply_align_local(coeffs: qdf.QDF, axes, six, center) -> qdf.QDF:
    """yaw, pitch, roll about local axes at ``center``, then the local
    decenters.  Takes leading batch dims (one mirror per batch entry)."""
    pitch, roll, yaw = six[..., 0], six[..., 1], six[..., 2]
    dx, dy, dz = six[..., 3:4], six[..., 4:5], six[..., 5:6]
    ax_x, ax_y, ax_z = axes[..., 0, :], axes[..., 1, :], axes[..., 2, :]
    coeffs, _ = qdf.rotate_about_axis(coeffs, ax_z, yaw, center)
    coeffs, _ = qdf.rotate_about_axis(coeffs, ax_y, pitch, center)
    coeffs, _ = qdf.rotate_about_axis(coeffs, ax_x, roll, center)
    return qdf.shift(coeffs, dx * ax_x + dy * ax_y + dz * ax_z)


def build_wolter_3_1(spec: AKBSpec, params: AlignParams,
                     source_shift=(0.0, 0.0, 0.0),
                     unit_coupled: bool | str = False,
                     fan_centering: str = "theta1",
                     ref_shift_z_bug: bool = False) -> OpticalSystem:
    """Place the four mirrors of a Wolter III+I AKB system on the device
    of ``params``.

    Mirror order: hyp_V -> ell_V -> ell_H -> hyp_H (hyp_H intersects on
    the negative root branch).  ``unit_coupled``: ``False`` rotates each
    mirror about its own chief-ray center; ``True`` rotates each Wolter
    pair as a unit (the V hyperbola drives the V unit, ell_V gets relative
    corrections); ``"h"`` couples only the H pair.  ``fan_centering``:
    ``"theta1"`` subtracts the chief design angle from the fan, ``"mean"``
    the fan midpoint.  The coefficient placement runs in double-f64
    (:mod:`akbx_torch.core.quadric_df`), akbx's default ``precise=True``.
    """
    if ref_shift_z_bug:
        raise NotImplementedError(
            "the reference shift_z-bug emulation serves only the oracle "
            "parity tests and is not ported (ROADMAP Queue 1, item 2)")
    dev = params.defocus.device

    def f64(x):
        return torch.as_tensor(x, dtype=F64, device=dev)

    src_shift = f64(source_shift)
    org_hyp_v, org_ell_v = spec.org_hyp_v, spec.org_ell_v
    org_ell_h, org_hyp_h = spec.org_ell_h, spec.org_hyp_h

    # --- canonical conics and edge coordinates ---
    c_v = geo.shift_x(hyperbola_coeffs(spec.a_hyp_v, spec.b_hyp_v, "xz", dev),
                      f64(org_hyp_v))
    x1_v, y1_v, x2_v, y2_v, ok_v = _edges_on_conic(
        c_v, spec.theta1_v, spec.length_hyp_v,
        lambda x: design.hyperbola_y(spec.a_hyp_v, spec.b_hyp_v, x),
        vertical=True)
    c_h = geo.shift_x(ellipse_coeffs(spec.a_ell_h, spec.b_ell_h, "xy", dev),
                      f64(org_ell_h))
    x1_h, y1_h, x2_h, y2_h, ok_h = _edges_on_conic(
        c_h, spec.theta1_h, spec.length_ell_h,
        lambda x: design.ellipse_y(spec.a_ell_h, spec.b_ell_h, x),
        vertical=False)

    # --- in-plane rotation target omega_V ---
    th_v1 = torch.atan(y1_v / x1_v)
    th_v2 = torch.atan(y2_v / x2_v)
    *_, t5_df = qdf.wolter_iii_angles_df(
        spec.a_hyp_v, spec.b_hyp_v, spec.a_ell_v, spec.b_ell_v,
        torch.stack([th_v1, th_v2]))
    om_hi = t5_df.hi[0] + t5_df.hi[1]
    om_lo = t5_df.lo[0] + t5_df.lo[1]
    omega_v = (om_hi + om_lo + th_v1 + th_v2) / 2

    # --- mirrors 1-4: base placement as one batch of 4 ---
    eye3 = torch.eye(3, dtype=F64, device=dev)
    astig = params.astig_h
    base_q = torch.stack([
        hyperbola_coeffs(spec.a_hyp_v, spec.b_hyp_v, "xz", dev),
        ellipse_coeffs(spec.a_ell_v, spec.b_ell_v, "xz", dev),
        ellipse_coeffs(spec.a_ell_h, spec.b_ell_h, "xy", dev),
        hyperbola_coeffs(spec.a_hyp_h, spec.b_hyp_h, "xy", dev),
    ])
    base_s = torch.stack([
        f64(org_hyp_v),
        f64(2 * org_hyp_v + org_ell_v),
        org_ell_h + astig,
        -org_hyp_h + 2 * org_ell_h + astig,
    ])
    base_axis = torch.stack([eye3[1], eye3[1], eye3[2], eye3[2]])
    base_theta = f64([spec.theta1_v, spec.theta1_v,
                      -spec.theta1_h, -spec.theta1_h])
    q_base, R_base = qdf.rotate_about_axis(
        qdf.shift_x(qdf.QDF.from_f64(base_q), base_s), base_axis, base_theta,
        torch.zeros((4, 3), dtype=F64, device=dev))
    coeffs_hyp_v, coeffs_ell_v, coeffs_ell_h_pre, coeffs_hyp_h_pre = \
        q_base.unbind()
    ax1, ax2, ax3, ax4 = (R_base @ eye3.T).transpose(-1, -2).unbind(0)

    # --- chief-ray pre-trace ---
    theta_cntr_v = (th_v1 + th_v2) / 2
    one, zero = f64(1.0), f64(0.0)
    bufray = torch.stack([
        torch.stack([one, zero, zero]),
        torch.stack([one, zero, torch.tan(th_v1 - theta_cntr_v)]),
        torch.stack([one, zero, torch.tan(th_v2 - theta_cntr_v)]),
    ], dim=1)
    bufray = geo.normalize(bufray)
    buf_src = torch.zeros((3, 3), dtype=F64, device=dev)

    center_hyp_v, _, okb1 = geo.intersect(coeffs_hyp_v.to_f64(), bufray,
                                          buf_src)
    bufreflect1 = geo.reflect(
        bufray, geo.surface_normal(coeffs_hyp_v.to_f64(), center_hyp_v))
    center_ell_v, _, okb2 = geo.intersect(coeffs_ell_v.to_f64(), bufreflect1,
                                          center_hyp_v)
    bufreflect2 = geo.reflect(
        bufreflect1, geo.surface_normal(coeffs_ell_v.to_f64(), center_ell_v))
    mean_center_ell_v = torch.mean(center_ell_v[:, 1:], dim=1)

    # --- H pair: pre-omega intersect of ell_H ---
    _, _, okb3 = geo.intersect(coeffs_ell_h_pre.to_f64(), bufreflect2,
                               center_ell_v)

    # --- in-plane omega rotation of the H pair, as one batch of 2 ---
    q_h, R_h = qdf.rotate_about_axis(
        qdf.QDF.stack([coeffs_ell_h_pre, coeffs_hyp_h_pre]),
        torch.stack([ax3[1], ax4[1]]), omega_v.expand(2),
        mean_center_ell_v.expand(2, 3))
    coeffs_ell_h, coeffs_hyp_h = q_h.unbind()
    ax3 = (R_h[0] @ ax3.T).T
    ax4 = (R_h[1] @ ax4.T).T

    center_ell_h, _, okb3b = geo.intersect(coeffs_ell_h.to_f64(), bufreflect2,
                                           center_ell_v)
    bufreflect3 = geo.reflect(
        bufreflect2, geo.surface_normal(coeffs_ell_h.to_f64(), center_ell_h))

    # --- mirror 4: pre-omega then placed (negative root branch) ---
    _, _, okb4 = geo.intersect(coeffs_hyp_h_pre.to_f64(), bufreflect3,
                               center_ell_h, branch=-1)
    center_hyp_h, _, okb4b = geo.intersect(coeffs_hyp_h.to_f64(), bufreflect3,
                                           center_ell_h, branch=-1)

    # --- geometry sanity ---
    no_conflict = (
        (center_ell_v[0, 0] > center_hyp_v[0, 0])
        & (center_ell_h[0, 0] > center_ell_v[0, 0])
        & (center_hyp_h[0, 0] > center_ell_h[0, 0])
    )
    valid = (ok_v & ok_h & torch.all(okb1) & torch.all(okb2)
             & torch.all(okb3) & torch.all(okb3b) & torch.all(okb4)
             & torch.all(okb4b) & no_conflict)

    # --- misalignment ---
    mean_c1 = torch.mean(center_hyp_v[:, 1:], dim=1)
    mean_c2 = torch.mean(center_ell_v[:, 1:], dim=1)
    mean_c3 = torch.mean(center_ell_h[:, 1:], dim=1)
    mean_c4 = torch.mean(center_hyp_h[:, 1:], dim=1)

    def rot(coeffs, axis, theta, center):
        return qdf.rotate_about_axis(coeffs, axis, theta, center)[0]

    def decenter(coeffs, axes, six):
        return qdf.shift(coeffs,
                       six[3] * axes[0] + six[4] * axes[1] + six[5] * axes[2])

    if unit_coupled:
        # the H pair rotates together about the H-unit center
        center_wolter_h = (mean_c3 + mean_c4) / 2
        p3, r3, y3 = params.ell_h[0], params.ell_h[1], params.ell_h[2]
        p4, r4, y4 = params.hyp_h[0], params.hyp_h[1], params.hyp_h[2]
        coeffs_ell_h = rot(coeffs_ell_h, ax3[1], p3, center_wolter_h)
        coeffs_ell_h = rot(coeffs_ell_h, ax3[2], y3, center_wolter_h)
        coeffs_ell_h = rot(coeffs_ell_h, ax3[0], r3, center_wolter_h)
        coeffs_hyp_h = rot(coeffs_hyp_h, ax4[1], p4, center_wolter_h)
        coeffs_hyp_h = rot(coeffs_hyp_h, ax4[2], y4, center_wolter_h)
        coeffs_hyp_h = rot(coeffs_hyp_h, ax4[0], r4, center_wolter_h)
    if unit_coupled == "h":
        # V mirrors independent; decenters per mirror
        coeffs_ell_h = decenter(coeffs_ell_h, ax3, params.ell_h)
        coeffs_hyp_h = decenter(coeffs_hyp_h, ax4, params.hyp_h)
        coeffs_hyp_v = _apply_align_local(coeffs_hyp_v, ax1, params.hyp_v,
                                          mean_c1)
        coeffs_ell_v = _apply_align_local(coeffs_ell_v, ax2, params.ell_v,
                                          mean_c2)
    elif unit_coupled:
        # the V hyperbola drives the V unit; ell_v gets relative corrections
        center_wolter_v = (mean_c1 + mean_c2) / 2
        p1, r1, y1 = params.hyp_v[0], params.hyp_v[1], params.hyp_v[2]
        p2, r2, y2 = params.ell_v[0], params.ell_v[1], params.ell_v[2]
        coeffs_hyp_v = rot(coeffs_hyp_v, ax1[2], y1, center_wolter_v)
        coeffs_ell_v = rot(coeffs_ell_v, ax2[2], y1, center_wolter_v)
        coeffs_hyp_v = rot(coeffs_hyp_v, ax1[1], p1, center_wolter_v)
        coeffs_ell_v = rot(coeffs_ell_v, ax2[1], p1, center_wolter_v)
        coeffs_hyp_v = rot(coeffs_hyp_v, ax1[0], r1, center_wolter_v)
        coeffs_ell_v = rot(coeffs_ell_v, ax2[0], r1, center_wolter_v)
        coeffs_ell_v = rot(coeffs_ell_v, ax2[2], y2 - y1, mean_c2)
        coeffs_ell_v = rot(coeffs_ell_v, ax2[1], p2 - p1, mean_c2)
        coeffs_ell_v = rot(coeffs_ell_v, ax2[0], r2 - r1, mean_c2)
        coeffs_hyp_v = decenter(coeffs_hyp_v, ax1, params.hyp_v)
        coeffs_hyp_h = decenter(coeffs_hyp_h, ax4, params.hyp_h)
        coeffs_ell_v = decenter(coeffs_ell_v, ax2, params.ell_v)
        coeffs_ell_h = decenter(coeffs_ell_h, ax3, params.ell_h)
    else:
        # independent per-mirror misalignment, as one batch of 4
        q_mis = _apply_align_local(
            qdf.QDF.stack([coeffs_hyp_v, coeffs_ell_v, coeffs_ell_h, coeffs_hyp_h]),
            torch.stack([ax1, ax2, ax3, ax4]),
            torch.stack([params.hyp_v, params.ell_v, params.ell_h,
                         params.hyp_h]),
            torch.stack([mean_c1, mean_c2, mean_c3, mean_c4]))
        coeffs_hyp_v, coeffs_ell_v, coeffs_ell_h, coeffs_hyp_h = \
            q_mis.unbind()

    # --- detector geometry ---
    s2f_H = -2 * org_hyp_h + 2 * org_ell_h
    s2f_V = 2 * org_hyp_v + 2 * org_ell_v
    s2f_middle = f64((s2f_H + s2f_V) / 2)

    # --- source-fan angle ranges ---
    a1_h = torch.atan((y1_h - src_shift[1]) / (x1_h - src_shift[0]))
    a2_h = torch.atan((y2_h - src_shift[1]) / (x2_h - src_shift[0]))
    a1_v = torch.atan((y1_v - src_shift[2]) / (x1_v - src_shift[0]))
    a2_v = torch.atan((y2_v - src_shift[2]) / (x2_v - src_shift[0]))
    if fan_centering == "mean":
        off_h, off_v = (a1_h + a2_h) / 2, (a1_v + a2_v) / 2
    else:
        off_h, off_v = spec.theta1_h, spec.theta1_v
    fan_h = torch.stack([a1_h - off_h, a2_h - off_h])
    fan_v = torch.stack([a1_v - off_v, a2_v - off_v])

    mirrors = (
        make_mirror(coeffs_hyp_v.to_f64(), +1.0, mean_c1, ax1),
        make_mirror(coeffs_ell_v.to_f64(), +1.0, mean_c2, ax2),
        make_mirror(coeffs_ell_h.to_f64(), +1.0, mean_c3, ax3),
        make_mirror(coeffs_hyp_h.to_f64(), -1.0, mean_c4, ax4),
    )
    return OpticalSystem(mirrors, s2f_middle, fan_h, fan_v, src_shift, valid)
