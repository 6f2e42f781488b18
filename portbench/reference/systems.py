"""System builders of the reference: a frozen copy of the two builders
of ``akbx_torch/systems.py`` that the align cells drive, with only the
options those cells use: ``build_wolter_3_1`` (Wolter III+I, placed in
double-f64, each mirror misaligned about its own chief-ray center, the
fan centred on the design angles) and ``build_kb`` (two ellipses, plain
f64).  Mirror order and the 26-vector ``[defocus, astigH] + 4 x [pitch,
roll, yaw, decenterX, decenterY, decenterZ]`` are the program's.  Plain
PyTorch; imports nothing of the program."""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from portbench.reference import design
from portbench.reference import geometry as geo
from portbench.reference import quadric_df as qdf
from portbench.reference.design import (ellipse_coeffs, hyperbola_coeffs,
                                        make_mirror)

F64 = torch.float64


class AlignParams(NamedTuple):
    """The 26 alignment degrees of freedom."""

    defocus: torch.Tensor
    astig_h: torch.Tensor
    # per mirror: pitch, roll, yaw, dx, dy, dz
    hyp_v: torch.Tensor  # (6,)
    hyp_h: torch.Tensor  # (6,)
    ell_v: torch.Tensor  # (6,)
    ell_h: torch.Tensor  # (6,)

    @staticmethod
    def from_vector(v: torch.Tensor) -> "AlignParams":
        return AlignParams(v[0], v[1], v[2:8], v[8:14], v[14:20], v[20:26])


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


class P:
    """The double-f64 quadric ops (:mod:`portbench.reference.quadric_df`)
    under the names the Wolter III+I builder uses."""

    lift = staticmethod(qdf.QDF.from_f64)
    stack = staticmethod(qdf.QDF.stack)
    shift = staticmethod(qdf.shift)
    shift_x = staticmethod(qdf.shift_x)
    rotate_about_axis = staticmethod(qdf.rotate_about_axis)

    @staticmethod
    def f64(q):
        return q.to_f64()

    @staticmethod
    def unbind(q):
        return q.unbind()


def _apply_align_local(coeffs, axes, six, center, ops=P):
    """yaw, pitch, roll about local axes at ``center``, then the local
    decenters.  Takes leading batch dims (one mirror per batch entry)."""
    pitch, roll, yaw = six[..., 0], six[..., 1], six[..., 2]
    dx, dy, dz = six[..., 3:4], six[..., 4:5], six[..., 5:6]
    ax_x, ax_y, ax_z = axes[..., 0, :], axes[..., 1, :], axes[..., 2, :]
    coeffs, _ = ops.rotate_about_axis(coeffs, ax_z, yaw, center)
    coeffs, _ = ops.rotate_about_axis(coeffs, ax_y, pitch, center)
    coeffs, _ = ops.rotate_about_axis(coeffs, ax_x, roll, center)
    return ops.shift(coeffs, dx * ax_x + dy * ax_y + dz * ax_z)


def build_wolter_3_1(spec: AKBSpec, params: AlignParams,
                     source_shift=(0.0, 0.0, 0.0)) -> OpticalSystem:
    """Place the four mirrors of a Wolter III+I AKB system on the device
    of ``params``.

    Mirror order: hyp_V -> ell_V -> ell_H -> hyp_H (hyp_H intersects on
    the negative root branch).  Each mirror rotates about its own
    chief-ray center; the fan is centred on the chief design angles; the
    coefficient placement and the layout angle chain run in double-f64.
    """
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
    q_base, R_base = P.rotate_about_axis(
        P.shift_x(P.lift(base_q), base_s), base_axis, base_theta,
        torch.zeros((4, 3), dtype=F64, device=dev))
    coeffs_hyp_v, coeffs_ell_v, coeffs_ell_h_pre, coeffs_hyp_h_pre = \
        P.unbind(q_base)
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

    center_hyp_v, _, okb1 = geo.intersect(P.f64(coeffs_hyp_v), bufray,
                                          buf_src)
    bufreflect1 = geo.reflect(
        bufray, geo.surface_normal(P.f64(coeffs_hyp_v), center_hyp_v))
    center_ell_v, _, okb2 = geo.intersect(P.f64(coeffs_ell_v), bufreflect1,
                                          center_hyp_v)
    bufreflect2 = geo.reflect(
        bufreflect1, geo.surface_normal(P.f64(coeffs_ell_v), center_ell_v))
    mean_center_ell_v = torch.mean(center_ell_v[:, 1:], dim=1)

    # --- H pair: pre-omega intersect of ell_H ---
    _, _, okb3 = geo.intersect(P.f64(coeffs_ell_h_pre), bufreflect2,
                               center_ell_v)

    # --- in-plane omega rotation of the H pair, as one batch of 2 ---
    q_h, R_h = P.rotate_about_axis(
        P.stack([coeffs_ell_h_pre, coeffs_hyp_h_pre]),
        torch.stack([ax3[1], ax4[1]]), omega_v.expand(2),
        mean_center_ell_v.expand(2, 3))
    coeffs_ell_h, coeffs_hyp_h = P.unbind(q_h)
    ax3 = (R_h[0] @ ax3.T).T
    ax4 = (R_h[1] @ ax4.T).T

    center_ell_h, _, okb3b = geo.intersect(P.f64(coeffs_ell_h), bufreflect2,
                                           center_ell_v)
    bufreflect3 = geo.reflect(
        bufreflect2, geo.surface_normal(P.f64(coeffs_ell_h), center_ell_h))

    # --- mirror 4: pre-omega then placed (negative root branch) ---
    _, _, okb4 = geo.intersect(P.f64(coeffs_hyp_h_pre), bufreflect3,
                               center_ell_h, branch=-1)
    center_hyp_h, _, okb4b = geo.intersect(P.f64(coeffs_hyp_h), bufreflect3,
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

    # independent per-mirror misalignment, as one batch of 4
    q_mis = _apply_align_local(
        P.stack([coeffs_hyp_v, coeffs_ell_v, coeffs_ell_h, coeffs_hyp_h]),
        torch.stack([ax1, ax2, ax3, ax4]),
        torch.stack([params.hyp_v, params.ell_v, params.ell_h,
                     params.hyp_h]),
        torch.stack([mean_c1, mean_c2, mean_c3, mean_c4]), P)
    coeffs_hyp_v, coeffs_ell_v, coeffs_ell_h, coeffs_hyp_h = \
        P.unbind(q_mis)

    # --- detector geometry ---
    s2f_H = -2 * org_hyp_h + 2 * org_ell_h
    s2f_V = 2 * org_hyp_v + 2 * org_ell_v
    s2f_middle = f64((s2f_H + s2f_V) / 2)

    # --- source-fan angle ranges ---
    a1_h = torch.atan((y1_h - src_shift[1]) / (x1_h - src_shift[0]))
    a2_h = torch.atan((y2_h - src_shift[1]) / (x2_h - src_shift[0]))
    a1_v = torch.atan((y1_v - src_shift[2]) / (x1_v - src_shift[0]))
    a2_v = torch.atan((y2_v - src_shift[2]) / (x2_v - src_shift[0]))
    off_h, off_v = spec.theta1_h, spec.theta1_v
    fan_h = torch.stack([a1_h - off_h, a2_h - off_h])
    fan_v = torch.stack([a1_v - off_v, a2_v - off_v])

    mirrors = (
        make_mirror(P.f64(coeffs_hyp_v), +1.0, mean_c1, ax1),
        make_mirror(P.f64(coeffs_ell_v), +1.0, mean_c2, ax2),
        make_mirror(P.f64(coeffs_ell_h), +1.0, mean_c3, ax3),
        make_mirror(P.f64(coeffs_hyp_h), -1.0, mean_c4, ax4),
    )
    return OpticalSystem(mirrors, s2f_middle, fan_h, fan_v, src_shift, valid)


@dataclasses.dataclass(frozen=True)
class KBSpec:
    """Design constants of a KB pair: two elliptical mirrors, the first
    deflecting vertically (z), the second horizontally (y).  The first
    traced mirror takes :func:`akbx_torch.design.kb_define`'s "h" ellipse,
    as akbx's ``from_kb_define`` remaps it."""

    a_v: float  # first mirror ellipse semi-major
    b_v: float
    a_h: float  # second mirror ellipse
    b_h: float
    theta1_v: float  # chief input angle of mirror 1
    theta1_h: float
    x1_v: float  # mirror 1 edge coordinates (canonical frame)
    y1_v: float
    x2_v: float
    y2_v: float
    x1_h: float
    y1_h: float
    x2_h: float
    y2_h: float

    @property
    def org_v(self):
        return math.sqrt(self.a_v**2 - self.b_v**2)

    @property
    def org_h(self):
        return math.sqrt(self.a_h**2 - self.b_h**2)

    @staticmethod
    def from_kb_define(l1h, l2h, inc_h, mlen_h, wd_v, inc_v, mlen_v,
                       device) -> "KBSpec":
        """From the 7-parameter KB definition, computed on ``device``."""
        kb = design.kb_define(l1h, l2h, inc_h, mlen_h, wd_v, inc_v, mlen_v,
                              device=device)
        return KBSpec(
            a_v=float(kb.a_h), b_v=float(kb.b_h),
            a_h=float(kb.a_v), b_h=float(kb.b_v),
            theta1_v=float(kb.theta1_h), theta1_h=float(kb.theta1_v),
            x1_v=float(kb.xh_s), y1_v=float(kb.yh_s),
            x2_v=float(kb.xh_e), y2_v=float(kb.yh_e),
            x1_h=float(kb.xv_s), y1_h=float(kb.yv_s),
            x2_h=float(kb.xv_e), y2_h=float(kb.yv_e),
        )



def ellipse_layout(a, b, f, theta1):
    """Single-ellipse layout: input angle -> focal-side angle and
    distances.  Returns (width1, width3, theta5, l1, l4, theta4)."""
    l4 = ((f**2 - 2 * f * a * torch.cos(theta1) + a**2)
          / (a - f * torch.cos(theta1)))
    l1 = 2 * a - l4
    theta5 = torch.asin((2 * a - l4) * torch.sin(theta1) / l4)
    theta4 = torch.asin(2 * f * torch.sin(theta1) / l4) / 2
    return (l1 * torch.cos(theta1), l4 * torch.cos(theta5), theta5, l1, l4,
            theta4)


def _fan(y1, x1, y2, x2, src_w, src_x, off):
    """The source-fan angle range ``(lo, hi)`` of a mirror's edges, less
    the offset ``off``."""
    return torch.stack([torch.atan((y1 - src_w) / (x1 - src_x)) - off,
                        torch.atan((y2 - src_w) / (x2 - src_x)) - off])


def _five_ray_bundle(th_h1, th_h2, th_v1, th_v2, theta1_h, theta1_v, dev):
    """The KB-style chief pre-trace bundle: the chief ray and four corner
    rays, normalized (3, 5)."""
    cntr_h = (th_h1 + th_h2) / 2
    cntr_v = (th_v1 + th_v2) / 2
    t1h = torch.tan(torch.as_tensor(theta1_h, dtype=F64, device=dev))
    t1v = torch.tan(torch.as_tensor(theta1_v, dtype=F64, device=dev))
    h1, h2 = torch.tan(th_h1 - cntr_h), torch.tan(th_h2 - cntr_h)
    v1, v2 = torch.tan(th_v1 - cntr_v), torch.tan(th_v2 - cntr_v)
    ts_h = torch.stack([t1h, h1, h2, h2, h2])
    ts_v = torch.stack([t1v, v1, v1, v1, v2])
    return geo.normalize(torch.stack([torch.ones_like(ts_h), ts_h, ts_v]))


def build_kb(spec: KBSpec, params: AlignParams,
             source_shift=(0.0, 0.0, 0.0)) -> OpticalSystem:
    """Place a KB pair (two elliptical mirrors) on the device of
    ``params``, in plain f64.  The misalignment channels hyp_v and hyp_h
    of :class:`AlignParams` drive mirrors 1 and 2 (the reference's
    naming); the other channels do nothing here.  Mirror 1 rotates about
    the global axes at its chief center, mirror 2 about its local axes;
    both decenters are global shifts."""
    dev = params.defocus.device

    def f64(x):
        return torch.as_tensor(x, dtype=F64, device=dev)

    src_shift = f64(source_shift)
    org_v, org_h = spec.org_v, spec.org_h
    eye3 = torch.eye(3, dtype=F64, device=dev)
    zero3 = torch.zeros(3, dtype=F64, device=dev)

    th_v1 = torch.atan(f64(spec.y1_v / spec.x1_v))
    th_v2 = torch.atan(f64(spec.y2_v / spec.x2_v))
    th_h1 = torch.atan(f64(spec.y1_h / spec.x1_h))
    th_h2 = torch.atan(f64(spec.y2_h / spec.x2_h))

    # omega_V from the focal-side edge angles
    t5_v1 = ellipse_layout(spec.a_v, spec.b_v, org_v, th_v1)[2]
    t5_v2 = ellipse_layout(spec.a_v, spec.b_v, org_v, th_v2)[2]
    omega_v = (th_v1 + th_v2 + t5_v1 + t5_v2) / 2

    # mirror 1 (V): ellipse in xz rotated about y by theta1_v
    coeffs_1 = geo.shift_x(ellipse_coeffs(spec.a_v, spec.b_v, "xz", dev),
                           f64(org_v))
    coeffs_1, R = geo.rotate_about_axis(coeffs_1, eye3[1],
                                        f64(spec.theta1_v), zero3)
    ax1 = (R @ eye3.T).T

    # chief-ray pre-trace: center + 4 corners
    theta_cntr_h = (th_h1 + th_h2) / 2
    theta_cntr_v = (th_v1 + th_v2) / 2
    bufray = _five_ray_bundle(th_h1, th_h2, th_v1, th_v2, spec.theta1_h,
                              spec.theta1_v, dev)
    buf_src = torch.zeros((3, 5), dtype=F64, device=dev)
    center_1, _, okb1 = geo.intersect(coeffs_1, bufray, buf_src)
    bufreflect1 = geo.reflect(bufray, geo.surface_normal(coeffs_1, center_1))

    # mirror 2 (H): ellipse in xy, astig shift, rotated about z by
    # -theta1_h, then in-plane rotation omega_V about its center
    coeffs_2 = geo.shift_x(ellipse_coeffs(spec.a_h, spec.b_h, "xy", dev),
                           org_h + params.astig_h)
    coeffs_2, R = geo.rotate_about_axis(coeffs_2, eye3[2],
                                        f64(-spec.theta1_h), zero3)
    ax2 = (R @ eye3.T).T
    center_2, _, okb2 = geo.intersect(coeffs_2, bufreflect1, center_1)
    mean_c2 = torch.mean(center_2[:, 1:], dim=1)
    coeffs_2, R = geo.rotate_about_axis(coeffs_2, eye3[1], omega_v, mean_c2)
    ax2 = (R @ ax2.T).T
    center_2, _, okb2b = geo.intersect(coeffs_2, bufreflect1, center_1)

    valid = torch.all(okb1) & torch.all(okb2) & torch.all(okb2b)

    # misalignment
    c1 = center_1[:, 0]
    mean_c2b = torch.mean(center_2[:, 1:], dim=1)
    p1, r1, y1 = params.hyp_v[0], params.hyp_v[1], params.hyp_v[2]
    coeffs_1 = geo.rotate_y(coeffs_1, p1, c1)
    coeffs_1 = geo.rotate_x(coeffs_1, r1, c1)
    coeffs_1 = geo.rotate_z(coeffs_1, y1, c1)
    p2, r2, y2 = params.hyp_h[0], params.hyp_h[1], params.hyp_h[2]
    coeffs_2, _ = geo.rotate_about_axis(coeffs_2, ax2[1], p2, mean_c2b)
    coeffs_2, _ = geo.rotate_about_axis(coeffs_2, ax2[2], y2, mean_c2b)
    coeffs_2, _ = geo.rotate_about_axis(coeffs_2, ax2[0], r2, mean_c2b)
    coeffs_1 = geo.shift(coeffs_1, params.hyp_v[3:6])
    coeffs_2 = geo.shift(coeffs_2, params.hyp_h[3:6])

    s2f_middle = f64((2 * org_h + 2 * org_v) / 2)
    # fan ranges: KB subtracts the mean edge angle
    fan_h = _fan(f64(spec.y1_h), f64(spec.x1_h), f64(spec.y2_h),
                 f64(spec.x2_h), src_shift[1], src_shift[0], theta_cntr_h)
    fan_v = _fan(f64(spec.y1_v), f64(spec.x1_v), f64(spec.y2_v),
                 f64(spec.x2_v), src_shift[2], src_shift[0], theta_cntr_v)
    mirrors = (make_mirror(coeffs_1, +1.0, c1, ax1),
               make_mirror(coeffs_2, +1.0, mean_c2b, ax2))
    return OpticalSystem(mirrors, s2f_middle, fan_h, fan_v, src_shift, valid)


