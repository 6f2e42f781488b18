"""System builders (port of :mod:`akbx.systems`): the KB pair and the
three Wolter AKB orderings.

Each builder places the mirrors: canonical conics -> axial shifts and
rotations -> chief-ray pre-trace -> in-plane rotations -> per-mirror
misalignment from the 26-vector ``[defocus, astigH] + 4 x [pitch, roll,
yaw, decenterX, decenterY, decenterZ]`` (mirror order hyp_v, hyp_h,
ell_v, ell_h).  Placements that do not depend on each other run as one
batch where the JAX package vmaps.

* ``build_wolter_3_1``: hyp_V -> ell_V -> ell_H -> hyp_H, placed in
  double-f64 (or plain f64 with ``precise=False``);
* ``build_wolter_3_3_tandem``: hyp_V -> ell_V -> hyp_H -> ell_H;
* ``build_wolter_3_3_alternating``: hyp_V -> hyp_H -> ell_V -> ell_H, or
  only the V pair (``two_mirror_only``);
* ``build_kb``: two ellipses, V then H.

The last three place in plain f64, as akbx's do.  ``calibrate_uv`` sets
each mirror's figure-error footprint from a traced probe fan.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import NamedTuple

import torch

from akbx_torch import design, device_of, graphs, spans
from akbx_torch.core import geometry as geo
from akbx_torch.core import quadric_df as qdf
from akbx_torch.surfaces import (ellipse_coeffs, hyperbola_coeffs,
                                 make_mirror)

F64 = torch.float64


class _PlacementOps:
    """Quadric transform ops over double-word f64 (``precise``, the
    :mod:`akbx_torch.core.quadric_df` congruences) or plain f64; with
    ``bug_compat`` the plain-f64 ops with the reference's shift_z bug
    (:func:`akbx_torch.core.quadric_df.ref_shift_z_buggy`), for oracle
    parity only.  Every op takes leading batch dimensions."""

    def __init__(self, precise: bool, bug_compat: bool = False):
        self.bug_compat = bool(bug_compat)
        self.precise = bool(precise) and not self.bug_compat

    def lift(self, coeffs):
        return qdf.QDF.from_f64(coeffs) if self.precise else coeffs

    def f64(self, coeffs):
        return coeffs.to_f64() if self.precise else coeffs

    def stack(self, qs):
        """Stack per-mirror coefficient sets along a new leading axis."""
        return qdf.QDF.stack(qs) if self.precise else torch.stack(qs)

    def unbind(self, qs):
        return qs.unbind() if self.precise else qs.unbind(0)

    def shift(self, coeffs, t):
        if self.bug_compat:
            return qdf.ref_shift_buggy(coeffs, t)
        return qdf.shift(coeffs, t) if self.precise else geo.shift(coeffs, t)

    def shift_x(self, coeffs, s):
        return (qdf.shift_x(coeffs, s) if self.precise
                else geo.shift_x(coeffs, s))

    def transform(self, coeffs, R, center):
        """Rotate the surface by ``R`` about ``center``."""
        if self.bug_compat:
            return qdf.ref_transform_buggy(coeffs, R, center)
        return (qdf.transform(coeffs, R, center) if self.precise
                else geo.transform_quadric(coeffs, R, center))

    def rotate_about_axis(self, coeffs, axis, theta, center):
        R = geo.rodrigues(axis, theta)
        return self.transform(coeffs, R, center), R


_PLAIN = _PlacementOps(False)


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


# Alternate design data: "3型 Setting1" + "1型 setting1".
WOLTER_3_1_SETTING1 = AKBSpec(
    a_hyp_v=72.985, b_hyp_v=0.25261675784047,
    a_ell_v=0.0933, b_ell_v=0.0236745564714402,
    length_hyp_v=0.0345, length_ell_v=0.0594385752478948,
    theta1_v=4.92519127861222e-05,
    a_ell_h=73.07505, b_ell_h=0.420125678460643,
    a_hyp_h=0.0072, b_hyp_h=0.00369271404399535,
    length_hyp_h=0.01008239076, length_ell_h=0.026,
    theta1_h=0.000109393749605896,
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


def _apply_align_local(coeffs, axes, six, center, ops=_PLAIN):
    """yaw, pitch, roll about local axes at ``center``, then the local
    decenters.  Takes leading batch dims (one mirror per batch entry)."""
    pitch, roll, yaw = six[..., 0], six[..., 1], six[..., 2]
    dx, dy, dz = six[..., 3:4], six[..., 4:5], six[..., 5:6]
    ax_x, ax_y, ax_z = axes[..., 0, :], axes[..., 1, :], axes[..., 2, :]
    coeffs, _ = ops.rotate_about_axis(coeffs, ax_z, yaw, center)
    coeffs, _ = ops.rotate_about_axis(coeffs, ax_y, pitch, center)
    coeffs, _ = ops.rotate_about_axis(coeffs, ax_x, roll, center)
    return ops.shift(coeffs, dx * ax_x + dy * ax_y + dz * ax_z)


class _Layout31(NamedTuple):
    """What a Wolter III+I build computes without reading the 26-vector,
    made once per (spec, source shift, fan centering, ``precise``,
    ``ref_shift_z_bug``, device) by :func:`_layout_3_1`."""

    ops: _PlacementOps
    spec: AKBSpec
    base_q: torch.Tensor  # (4, 10) canonical conics, trace order
    shift_v: tuple  # the V pair's x shifts, 0-d
    R_base: torch.Tensor  # (4, 3, 3) axial rotations, about the origin
    origin: torch.Tensor  # (4, 3) zeros
    coeffs_v: tuple  # hyp_V, ell_V placed, before misalignment
    R_h: torch.Tensor  # (2, 3, 3) the H pair's rotation by omega_V
    center_ell_v: torch.Tensor  # (3, 3) the chief bundle on ell_V
    bufreflect2: torch.Tensor  # (3, 3) the bundle leaving ell_V
    valid_v: torch.Tensor  # the part of ``valid`` the V pair decides
    axes: tuple  # the four mirrors' frames (3, 3)
    mean_c: tuple  # hyp_V's and ell_V's chief centers (3,)
    s2f_middle: torch.Tensor
    fan_h: torch.Tensor
    fan_v: torch.Tensor
    source: torch.Tensor
    graphs: dict  # the placement's CUDA graphs (akbx_torch.graphs)


_LAYOUTS: dict = {}


def _layout_3_1(spec: AKBSpec, source_shift: tuple, fan_centering: str,
                precise: bool, ref_shift_z_bug: bool, dev) -> _Layout31:
    """The memoised layout of a III+I build; made eagerly, outside any
    autograd graph, on first use."""
    key = (spec, source_shift, fan_centering, precise, ref_shift_z_bug, dev)
    lay = _LAYOUTS.get(key)
    if lay is None:
        with torch.inference_mode(False), torch.no_grad():
            lay = _LAYOUTS[key] = _make_layout_3_1(*key)
    return lay


def _base_3_1(ops, spec, base_q, shift_v, R_base, origin, astig):
    """The four canonical conics shifted along x (the H pair by the astig
    shift more) and given their axial rotation, as one batch of 4."""
    org_ell_h, org_hyp_h = spec.org_ell_h, spec.org_hyp_h
    base_s = torch.stack([*shift_v, org_ell_h + astig,
                          -org_hyp_h + 2 * org_ell_h + astig])
    return ops.unbind(ops.transform(ops.shift_x(ops.lift(base_q), base_s),
                                    R_base, origin))


def _make_layout_3_1(spec, source_shift, fan_centering, precise,
                     ref_shift_z_bug, dev) -> _Layout31:
    P = _PlacementOps(precise, bug_compat=ref_shift_z_bug)

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
    if precise:
        *_, t5_df = qdf.wolter_iii_angles_df(
            spec.a_hyp_v, spec.b_hyp_v, spec.a_ell_v, spec.b_ell_v,
            torch.stack([th_v1, th_v2]))
        om_hi = t5_df.hi[0] + t5_df.hi[1]
        om_lo = t5_df.lo[0] + t5_df.lo[1]
        omega_v = (om_hi + om_lo + th_v1 + th_v2) / 2
    else:
        t5_v1, t5_v2 = (design.wolter_iii_angles(
            spec.a_hyp_v, spec.b_hyp_v, org_hyp_v, spec.a_ell_v,
            spec.b_ell_v, org_ell_v, th)[3] for th in (th_v1, th_v2))
        omega_v = (t5_v1 + t5_v2 + th_v1 + th_v2) / 2

    # --- mirrors 1-4: base placement as one batch of 4; the V pair's
    # rows do not depend on the astig shift ---
    eye3 = torch.eye(3, dtype=F64, device=dev)
    base_q = torch.stack([
        hyperbola_coeffs(spec.a_hyp_v, spec.b_hyp_v, "xz", dev),
        ellipse_coeffs(spec.a_ell_v, spec.b_ell_v, "xz", dev),
        ellipse_coeffs(spec.a_ell_h, spec.b_ell_h, "xy", dev),
        hyperbola_coeffs(spec.a_hyp_h, spec.b_hyp_h, "xy", dev),
    ])
    shift_v = (f64(org_hyp_v), f64(2 * org_hyp_v + org_ell_v))
    R_base = geo.rodrigues(torch.stack([eye3[1], eye3[1], eye3[2], eye3[2]]),
                           f64([spec.theta1_v, spec.theta1_v,
                                -spec.theta1_h, -spec.theta1_h]))
    origin = torch.zeros((4, 3), dtype=F64, device=dev)
    coeffs_hyp_v, coeffs_ell_v, _, _ = _base_3_1(
        P, spec, base_q, shift_v, R_base, origin, f64(0.0))
    ax1, ax2, ax3, ax4 = (R_base @ eye3.T).transpose(-1, -2).unbind(0)

    # --- chief-ray pre-trace through the V pair ---
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

    # --- the H pair's in-plane rotation by omega_V ---
    R_h = geo.rodrigues(torch.stack([ax3[1], ax4[1]]), omega_v.expand(2))
    ax3 = (R_h[0] @ ax3.T).T
    ax4 = (R_h[1] @ ax4.T).T

    valid_v = (ok_v & ok_h & torch.all(okb1) & torch.all(okb2)
               & (center_ell_v[0, 0] > center_hyp_v[0, 0]))
    mean_c1 = torch.mean(center_hyp_v[:, 1:], dim=1)
    mean_c2 = torch.mean(center_ell_v[:, 1:], dim=1)

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

    return _Layout31(P, spec, base_q, shift_v, R_base, origin,
                     (coeffs_hyp_v, coeffs_ell_v), R_h, center_ell_v,
                     bufreflect2, valid_v, (ax1, ax2, ax3, ax4),
                     (mean_c1, mean_c2), s2f_middle, fan_h, fan_v, src_shift,
                     {})


def _place_3_1(lay: _Layout31, unit_coupled, astig, hyp_v, hyp_h, ell_v,
               ell_h) -> tuple:
    """The part of a III+I build that reads the 26-vector: the H pair's
    astig shift and omega rotation, its chief pre-trace, ``valid`` and the
    misalignment.  Capturable (:mod:`akbx_torch.graphs`): no tensor from
    host data, no sync, no branch on a value.  Returns the four mirrors'
    f64 coefficients, the H pair's chief centers and ``valid``."""
    P = lay.ops
    # the whole batch of 4, as the layout runs it for the V rows (unused
    # here): every row comes out of the same kernels on the same shapes
    _, _, coeffs_ell_h_pre, coeffs_hyp_h_pre = _base_3_1(
        P, lay.spec, lay.base_q, lay.shift_v, lay.R_base, lay.origin, astig)
    coeffs_hyp_v, coeffs_ell_v = lay.coeffs_v
    ax1, ax2, ax3, ax4 = lay.axes
    mean_c1, mean_c2 = lay.mean_c
    center_ell_v, bufreflect2 = lay.center_ell_v, lay.bufreflect2

    # --- H pair: pre-omega intersect of ell_H, the rotation by omega_V
    # about ell_V's chief center as one batch of 2 ---
    _, _, okb3 = geo.intersect(P.f64(coeffs_ell_h_pre), bufreflect2,
                               center_ell_v)
    q_h = P.transform(P.stack([coeffs_ell_h_pre, coeffs_hyp_h_pre]),
                      lay.R_h, mean_c2.expand(2, 3))
    coeffs_ell_h, coeffs_hyp_h = P.unbind(q_h)

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
    valid = (lay.valid_v & torch.all(okb3) & torch.all(okb3b)
             & torch.all(okb4) & torch.all(okb4b)
             & (center_ell_h[0, 0] > center_ell_v[0, 0])
             & (center_hyp_h[0, 0] > center_ell_h[0, 0]))

    # --- misalignment ---
    mean_c3 = torch.mean(center_ell_h[:, 1:], dim=1)
    mean_c4 = torch.mean(center_hyp_h[:, 1:], dim=1)

    def rot(coeffs, axis, theta, center):
        return P.rotate_about_axis(coeffs, axis, theta, center)[0]

    def decenter(coeffs, axes, six):
        return P.shift(coeffs,
                       six[3] * axes[0] + six[4] * axes[1] + six[5] * axes[2])

    if unit_coupled:
        # the H pair rotates together about the H-unit center
        center_wolter_h = (mean_c3 + mean_c4) / 2
        p3, r3, y3 = ell_h[0], ell_h[1], ell_h[2]
        p4, r4, y4 = hyp_h[0], hyp_h[1], hyp_h[2]
        coeffs_ell_h = rot(coeffs_ell_h, ax3[1], p3, center_wolter_h)
        coeffs_ell_h = rot(coeffs_ell_h, ax3[2], y3, center_wolter_h)
        coeffs_ell_h = rot(coeffs_ell_h, ax3[0], r3, center_wolter_h)
        coeffs_hyp_h = rot(coeffs_hyp_h, ax4[1], p4, center_wolter_h)
        coeffs_hyp_h = rot(coeffs_hyp_h, ax4[2], y4, center_wolter_h)
        coeffs_hyp_h = rot(coeffs_hyp_h, ax4[0], r4, center_wolter_h)
    if unit_coupled == "h":
        # V mirrors independent; decenters per mirror
        coeffs_ell_h = decenter(coeffs_ell_h, ax3, ell_h)
        coeffs_hyp_h = decenter(coeffs_hyp_h, ax4, hyp_h)
        coeffs_hyp_v = _apply_align_local(coeffs_hyp_v, ax1, hyp_v, mean_c1,
                                          P)
        coeffs_ell_v = _apply_align_local(coeffs_ell_v, ax2, ell_v, mean_c2,
                                          P)
    elif unit_coupled:
        # the V hyperbola drives the V unit; ell_v gets relative corrections
        center_wolter_v = (mean_c1 + mean_c2) / 2
        p1, r1, y1 = hyp_v[0], hyp_v[1], hyp_v[2]
        p2, r2, y2 = ell_v[0], ell_v[1], ell_v[2]
        coeffs_hyp_v = rot(coeffs_hyp_v, ax1[2], y1, center_wolter_v)
        coeffs_ell_v = rot(coeffs_ell_v, ax2[2], y1, center_wolter_v)
        coeffs_hyp_v = rot(coeffs_hyp_v, ax1[1], p1, center_wolter_v)
        coeffs_ell_v = rot(coeffs_ell_v, ax2[1], p1, center_wolter_v)
        coeffs_hyp_v = rot(coeffs_hyp_v, ax1[0], r1, center_wolter_v)
        coeffs_ell_v = rot(coeffs_ell_v, ax2[0], r1, center_wolter_v)
        coeffs_ell_v = rot(coeffs_ell_v, ax2[2], y2 - y1, mean_c2)
        coeffs_ell_v = rot(coeffs_ell_v, ax2[1], p2 - p1, mean_c2)
        coeffs_ell_v = rot(coeffs_ell_v, ax2[0], r2 - r1, mean_c2)
        coeffs_hyp_v = decenter(coeffs_hyp_v, ax1, hyp_v)
        coeffs_hyp_h = decenter(coeffs_hyp_h, ax4, hyp_h)
        coeffs_ell_v = decenter(coeffs_ell_v, ax2, ell_v)
        coeffs_ell_h = decenter(coeffs_ell_h, ax3, ell_h)
    else:
        # independent per-mirror misalignment, as one batch of 4
        q_mis = _apply_align_local(
            P.stack([coeffs_hyp_v, coeffs_ell_v, coeffs_ell_h, coeffs_hyp_h]),
            torch.stack([ax1, ax2, ax3, ax4]),
            torch.stack([hyp_v, ell_v, ell_h, hyp_h]),
            torch.stack([mean_c1, mean_c2, mean_c3, mean_c4]), P)
        coeffs_hyp_v, coeffs_ell_v, coeffs_ell_h, coeffs_hyp_h = \
            P.unbind(q_mis)
    return (P.f64(coeffs_hyp_v), P.f64(coeffs_ell_v), P.f64(coeffs_ell_h),
            P.f64(coeffs_hyp_h), mean_c3, mean_c4, valid)


@spans.spanned("systems.build")
def build_wolter_3_1(spec: AKBSpec, params: AlignParams,
                     source_shift=(0.0, 0.0, 0.0),
                     unit_coupled: bool | str = False,
                     fan_centering: str = "theta1",
                     precise: bool = True,
                     ref_shift_z_bug: bool = False) -> OpticalSystem:
    """Place the four mirrors of a Wolter III+I AKB system on the device
    of ``params``.

    Mirror order: hyp_V -> ell_V -> ell_H -> hyp_H (hyp_H intersects on
    the negative root branch).  ``unit_coupled``: ``False`` rotates each
    mirror about its own chief-ray center; ``True`` rotates each Wolter
    pair as a unit (the V hyperbola drives the V unit, ell_V gets relative
    corrections); ``"h"`` couples only the H pair.  ``fan_centering``:
    ``"theta1"`` subtracts the chief design angle from the fan, ``"mean"``
    the fan midpoint.  ``precise`` runs the coefficient placement and the
    layout angle chain in double-f64 (:mod:`akbx_torch.core.quadric_df`),
    else in plain f64 (up to ~3e-8 rad of cancellation in omega_V).
    ``ref_shift_z_bug`` reproduces the reference's dropped ``h -= f*s``
    shift_z update (plain f64), for oracle parity only.

    The build runs in two parts: the layout, all that does not read
    ``params`` (:func:`_layout_3_1`, made once per spec, options and
    device), and the placement, all that does (:func:`_place_3_1`), which
    on a card replays from CUDA graphs, forward and backward
    (:func:`akbx_torch.graphs.call`).  Both return what one eager pass
    returns, bit for bit.
    """
    lay = _layout_3_1(spec, tuple(float(x) for x in source_shift),
                      fan_centering, bool(precise), bool(ref_shift_z_bug),
                      params.defocus.device)
    c1, c2, c3, c4, mean_c3, mean_c4, valid = graphs.call(
        lay.graphs, unit_coupled,
        functools.partial(_place_3_1, lay, unit_coupled),
        (params.astig_h, params.hyp_v, params.hyp_h, params.ell_v,
         params.ell_h))
    # the layout's tensors are shared: hand out copies
    ax1, ax2, ax3, ax4 = (a.clone() for a in lay.axes)
    mean_c1, mean_c2 = (c.clone() for c in lay.mean_c)
    mirrors = (
        make_mirror(c1, +1.0, mean_c1, ax1),
        make_mirror(c2, +1.0, mean_c2, ax2),
        make_mirror(c3, +1.0, mean_c3, ax3),
        make_mirror(c4, -1.0, mean_c4, ax4),
    )
    return OpticalSystem(mirrors, lay.s2f_middle.clone(), lay.fan_h.clone(),
                         lay.fan_v.clone(), lay.source.clone(), valid)


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
                       device=None) -> "KBSpec":
        """From the 7-parameter KB definition, computed on ``device``
        (default: the card)."""
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

    @staticmethod
    def from_ellipse_na(ell1, ell2) -> "KBSpec":
        """From two NA-based ellipse designs
        (:class:`akbx_torch.design.EllipseNA`, mirror-width-center input
        angle).  Reads only the attributes ``a``, ``b``,
        ``theta_i_cnt_m_wid``, ``x_1``, ``y_1``, ``edge`` and ``y_2`` of
        each."""
        return KBSpec(
            a_v=float(ell1.a), b_v=float(ell1.b),
            a_h=float(ell2.a), b_h=float(ell2.b),
            theta1_v=float(ell1.theta_i_cnt_m_wid),
            theta1_h=float(ell2.theta_i_cnt_m_wid),
            x1_v=float(ell1.x_1), y1_v=float(ell1.y_1),
            x2_v=float(ell1.edge), y2_v=float(ell1.y_2),
            x1_h=float(ell2.x_1), y1_h=float(ell2.y_1),
            x2_h=float(ell2.edge), y2_h=float(ell2.y_2),
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


@spans.spanned("systems.build")
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


def _edge_angles(x1, y1, x2, y2):
    return torch.atan(y1 / x1), torch.atan(y2 / x2)


def _wolter_3_3_edges(spec: AKBSpec, dev):
    """Edge coordinates of the V and H hyperbolas of a Wolter III+III
    system, and the validity of their chief intersections."""
    org_hyp_v, org_hyp_h = spec.org_hyp_v, spec.org_hyp_h

    def f64(x):
        return torch.as_tensor(x, dtype=F64, device=dev)

    c_v = geo.shift_x(hyperbola_coeffs(spec.a_hyp_v, spec.b_hyp_v, "xz", dev),
                      f64(org_hyp_v))
    edges_v = _edges_on_conic(
        c_v, spec.theta1_v, spec.length_hyp_v,
        lambda x: design.hyperbola_y(spec.a_hyp_v, spec.b_hyp_v, x),
        vertical=True)
    c_h = geo.shift_x(hyperbola_coeffs(spec.a_hyp_h, spec.b_hyp_h, "xy", dev),
                      f64(org_hyp_h))
    edges_h = _edges_on_conic(
        c_h, spec.theta1_h, spec.length_hyp_h,
        lambda x: design.hyperbola_y(spec.a_hyp_h, spec.b_hyp_h, x),
        vertical=False)
    return edges_v, edges_h


def _wolter_3_3_base(spec: AKBSpec, params: AlignParams, order):
    """The four canonical conics of a Wolter III+III system, shifted along
    x and given their axial rotation, as one batch: ``order`` names the
    mirrors in trace order among "hyp_v", "ell_v", "hyp_h", "ell_h".
    Returns (coeffs (4, 10), axes (4, 3, 3)) in that order."""
    dev = params.defocus.device
    org_hyp_v, org_ell_v = spec.org_hyp_v, spec.org_ell_v
    org_hyp_h = spec.org_hyp_h
    org_ell_h = math.sqrt(spec.a_ell_h**2 - spec.b_ell_h**2)
    eye3 = torch.eye(3, dtype=F64, device=dev)
    astig = params.astig_h

    def f64(x):
        return torch.as_tensor(x, dtype=F64, device=dev)

    # conic, x shift, rotation axis, rotation angle
    table = {
        "hyp_v": (hyperbola_coeffs(spec.a_hyp_v, spec.b_hyp_v, "xz", dev),
                  f64(org_hyp_v), eye3[1], spec.theta1_v),
        "ell_v": (ellipse_coeffs(spec.a_ell_v, spec.b_ell_v, "xz", dev),
                  f64(2 * org_hyp_v + org_ell_v), eye3[1], spec.theta1_v),
        "hyp_h": (hyperbola_coeffs(spec.a_hyp_h, spec.b_hyp_h, "xy", dev),
                  org_hyp_h + astig, eye3[2], -spec.theta1_h),
        "ell_h": (ellipse_coeffs(spec.a_ell_h, spec.b_ell_h, "xy", dev),
                  2 * org_hyp_h + org_ell_h + astig, eye3[2],
                  -spec.theta1_h),
    }
    rows = [table[name] for name in order]
    q, R = geo.rotate_about_axis(
        geo.shift_x(torch.stack([r[0] for r in rows]),
                    torch.stack([r[1] for r in rows])),
        torch.stack([r[2] for r in rows]), f64([r[3] for r in rows]),
        torch.zeros((4, 3), dtype=F64, device=dev))
    return q, (R @ eye3.T).transpose(-1, -2)


@spans.spanned("systems.build")
def build_wolter_3_3_tandem(spec: AKBSpec, params: AlignParams,
                            source_shift=(0.0, 0.0, 0.0)) -> OpticalSystem:
    """Wolter III+III tandem AKB: hyp_V -> ell_V -> hyp_H -> ell_H, placed
    in plain f64 on the device of ``params``.  Both pairs are
    hyperbola-then-ellipse; the spec's H fields are the H pair's
    hyperbola (a_hyp_h, b_hyp_h) and ellipse (a_ell_h, b_ell_h), with
    ``length_hyp_h`` the length of the first H mirror."""
    dev = params.defocus.device
    src_shift = torch.as_tensor(source_shift, dtype=F64, device=dev)
    org_hyp_v, org_ell_v = spec.org_hyp_v, spec.org_ell_v
    org_hyp_h = spec.org_hyp_h
    org_ell_h = math.sqrt(spec.a_ell_h**2 - spec.b_ell_h**2)

    ((x1_v, y1_v, x2_v, y2_v, ok_v),
     (x1_h, y1_h, x2_h, y2_h, ok_h)) = _wolter_3_3_edges(spec, dev)
    th_v1, th_v2 = _edge_angles(x1_v, y1_v, x2_v, y2_v)
    t5_v1, t5_v2 = (design.wolter_iii_angles(
        spec.a_hyp_v, spec.b_hyp_v, org_hyp_v, spec.a_ell_v, spec.b_ell_v,
        org_ell_v, th)[3] for th in (th_v1, th_v2))
    omega_v = (th_v1 + th_v2 + t5_v1 + t5_v2) / 2

    # mirrors 1-4: conics, x shifts and axial rotations as one batch of 4
    q, axes = _wolter_3_3_base(spec, params,
                               ("hyp_v", "ell_v", "hyp_h", "ell_h"))
    coeffs_hyp_v, coeffs_ell_v, coeffs_hyp_h, coeffs_ell_h = q.unbind(0)
    ax1, ax2, ax3, ax4 = axes.unbind(0)

    theta_cntr_v = (th_v1 + th_v2) / 2
    one, zero = torch.ones_like(th_v1), torch.zeros_like(th_v1)
    bufray = geo.normalize(torch.stack([
        torch.stack([one, zero, zero]),
        torch.stack([one, zero, torch.tan(th_v1 - theta_cntr_v)]),
        torch.stack([one, zero, torch.tan(th_v2 - theta_cntr_v)]),
    ], dim=1))
    buf_src = torch.zeros((3, 3), dtype=F64, device=dev)
    center_hyp_v, _, okb1 = geo.intersect(coeffs_hyp_v, bufray, buf_src)
    bufreflect1 = geo.reflect(bufray, geo.surface_normal(coeffs_hyp_v,
                                                         center_hyp_v))
    center_ell_v, _, okb2 = geo.intersect(coeffs_ell_v, bufreflect1,
                                          center_hyp_v)
    bufreflect2 = geo.reflect(bufreflect1, geo.surface_normal(coeffs_ell_v,
                                                              center_ell_v))
    mean_center_ell_v = torch.mean(center_ell_v[:, 1:], dim=1)

    # mirror 3 (hyp_H, positive branch) and mirror 4 (ell_H): the
    # pre-omega intersections, then the omega rotation of both about the
    # V ellipse's center as one batch of 2
    center_hyp_h, _, okb3 = geo.intersect(coeffs_hyp_h, bufreflect2,
                                          center_ell_v)
    q_h, R_h = geo.rotate_about_axis(
        torch.stack([coeffs_hyp_h, coeffs_ell_h]),
        torch.stack([ax3[1], ax4[1]]), omega_v.expand(2),
        mean_center_ell_v.expand(2, 3))
    coeffs_hyp_h_rot, coeffs_ell_h_rot = q_h.unbind(0)
    ax3 = (R_h[0] @ ax3.T).T
    center_hyp_h, _, okb3b = geo.intersect(coeffs_hyp_h_rot, bufreflect2,
                                           center_ell_v)
    bufreflect3 = geo.reflect(bufreflect2, geo.surface_normal(
        coeffs_hyp_h_rot, center_hyp_h))
    center_ell_h, _, okb4 = geo.intersect(coeffs_ell_h, bufreflect3,
                                          center_hyp_h)
    ax4 = (R_h[1] @ ax4.T).T
    center_ell_h, _, okb4b = geo.intersect(coeffs_ell_h_rot, bufreflect3,
                                           center_hyp_h)

    valid = (ok_v & ok_h & torch.all(okb1) & torch.all(okb2)
             & torch.all(okb3) & torch.all(okb3b) & torch.all(okb4)
             & torch.all(okb4b))

    # misalignment: independent local-axis chains, one batch of 4
    centers = [torch.mean(c[:, 1:], dim=1) for c in
               (center_hyp_v, center_ell_v, center_hyp_h, center_ell_h)]
    q_mis = _apply_align_local(
        torch.stack([coeffs_hyp_v, coeffs_ell_v, coeffs_hyp_h_rot,
                     coeffs_ell_h_rot]),
        torch.stack([ax1, ax2, ax3, ax4]),
        torch.stack([params.hyp_v, params.ell_v, params.hyp_h,
                     params.ell_h]),
        torch.stack(centers))

    s2f_H = 2 * org_hyp_h + 2 * org_ell_h
    s2f_V = 2 * org_hyp_v + 2 * org_ell_v
    s2f_middle = torch.as_tensor((s2f_H + s2f_V) / 2, dtype=F64, device=dev)
    # the III+III engines subtract the mean edge angle, not theta1
    cntr_h = (torch.atan(y1_h / x1_h) + torch.atan(y2_h / x2_h)) / 2
    cntr_v = (torch.atan(y1_v / x1_v) + torch.atan(y2_v / x2_v)) / 2
    fan_h = _fan(y1_h, x1_h, y2_h, x2_h, src_shift[1], src_shift[0], cntr_h)
    fan_v = _fan(y1_v, x1_v, y2_v, x2_v, src_shift[2], src_shift[0], cntr_v)
    mirrors = tuple(make_mirror(c, +1.0, m, a) for c, m, a in
                    zip(q_mis.unbind(0), centers, (ax1, ax2, ax3, ax4)))
    return OpticalSystem(mirrors, s2f_middle, fan_h, fan_v, src_shift, valid)


@spans.spanned("systems.build")
def build_wolter_3_3_alternating(spec: AKBSpec, params: AlignParams,
                                 source_shift=(0.0, 0.0, 0.0),
                                 two_mirror_only: bool = False
                                 ) -> OpticalSystem:
    """Wolter III+III alternating AKB: hyp_V -> hyp_H -> ell_V -> ell_H,
    placed in plain f64 on the device of ``params``.  Each mirror after
    the first gets its in-plane rotation about its own pre-rotation
    center.  ``two_mirror_only`` keeps only the V Wolter III pair (the
    reference's ``option_2mirror=False``), with a near-zero H fan."""
    dev = params.defocus.device
    src_shift = torch.as_tensor(source_shift, dtype=F64, device=dev)
    org_hyp_v, org_ell_v = spec.org_hyp_v, spec.org_ell_v
    org_hyp_h = spec.org_hyp_h
    org_ell_h = math.sqrt(spec.a_ell_h**2 - spec.b_ell_h**2)

    ((x1_v, y1_v, x2_v, y2_v, ok_v),
     (x1_h, y1_h, x2_h, y2_h, ok_h)) = _wolter_3_3_edges(spec, dev)
    th_v1, th_v2 = _edge_angles(x1_v, y1_v, x2_v, y2_v)
    th_h1, th_h2 = _edge_angles(x1_h, y1_h, x2_h, y2_h)

    # the V and H layout chains, each edge angle as one batch
    _, t3_v, _, t5_v, *_ = design.wolter_iii_angles(
        spec.a_hyp_v, spec.b_hyp_v, org_hyp_v, spec.a_ell_v, spec.b_ell_v,
        org_ell_v, torch.stack([th_v1, th_v2]))
    _, t3_h, _, _, *_ = design.wolter_iii_angles(
        spec.a_hyp_h, spec.b_hyp_h, org_hyp_h, spec.a_ell_h, spec.b_ell_h,
        org_ell_h, torch.stack([th_h1, th_h2]))
    omega_v1 = (t3_v[0] + t3_v[1] - th_v1 - th_v2) / 2
    omega_h1 = (t3_h[0] + t3_h[1] - th_h1 - th_h2) / 2
    omega_v2 = (th_v1 + th_v2 + t5_v[0] + t5_v[1]) / 2

    q, axes = _wolter_3_3_base(spec, params,
                               ("hyp_v", "hyp_h", "ell_v", "ell_h"))
    coeffs_hyp_v, coeffs_hyp_h, coeffs_ell_v, coeffs_ell_h = q.unbind(0)
    ax1, ax2, ax3, ax4 = axes.unbind(0)

    theta_cntr_h = (th_h1 + th_h2) / 2
    theta_cntr_v = (th_v1 + th_v2) / 2
    bufray = _five_ray_bundle(th_h1, th_h2, th_v1, th_v2, spec.theta1_h,
                              spec.theta1_v, dev)
    buf_src = torch.zeros((3, 5), dtype=F64, device=dev)
    center_hyp_v, _, okb1 = geo.intersect(coeffs_hyp_v, bufray, buf_src)
    bufreflect1 = geo.reflect(bufray, geo.surface_normal(coeffs_hyp_v,
                                                         center_hyp_v))

    def place(coeffs, ax, axis_row, omega, ray, origin):
        """Pre-rotation intersection, in-plane rotation by ``omega`` about
        its center, placed intersection."""
        center_pre, _, ok_pre = geo.intersect(coeffs, ray, origin)
        coeffs, R = geo.rotate_about_axis(
            coeffs, ax[axis_row], omega, torch.mean(center_pre[:, 1:], dim=1))
        center, _, ok = geo.intersect(coeffs, ray, origin)
        return coeffs, (R @ ax.T).T, center, ok_pre, ok

    coeffs_hyp_h, ax2, center_hyp_h, okb2, okb2b = place(
        coeffs_hyp_h, ax2, 1, -omega_v1, bufreflect1, center_hyp_v)
    bufreflect2 = geo.reflect(bufreflect1, geo.surface_normal(coeffs_hyp_h,
                                                              center_hyp_h))
    coeffs_ell_v, ax3, center_ell_v, okb3, okb3b = place(
        coeffs_ell_v, ax3, 2, omega_h1, bufreflect2, center_hyp_h)
    bufreflect3 = geo.reflect(bufreflect2, geo.surface_normal(coeffs_ell_v,
                                                              center_ell_v))
    coeffs_ell_h, ax4, center_ell_h, okb4, okb4b = place(
        coeffs_ell_h, ax4, 1, omega_v2, bufreflect3, center_ell_v)

    valid = (ok_v & ok_h & torch.all(okb1) & torch.all(okb2)
             & torch.all(okb2b) & torch.all(okb3) & torch.all(okb3b)
             & torch.all(okb4) & torch.all(okb4b))

    centers = [torch.mean(c[:, 1:], dim=1) for c in
               (center_hyp_v, center_hyp_h, center_ell_v, center_ell_h)]
    q_mis = _apply_align_local(
        torch.stack([coeffs_hyp_v, coeffs_hyp_h, coeffs_ell_v,
                     coeffs_ell_h]),
        torch.stack([ax1, ax2, ax3, ax4]),
        torch.stack([params.hyp_v, params.hyp_h, params.ell_v,
                     params.ell_h]),
        torch.stack(centers))

    s2f_H = 2 * org_hyp_h + 2 * org_ell_h
    s2f_V = 2 * org_hyp_v + 2 * org_ell_v
    s2f_middle = torch.as_tensor(
        s2f_V if two_mirror_only else (s2f_H + s2f_V) / 2, dtype=F64,
        device=dev)
    if two_mirror_only:
        fan_h = torch.tensor([-1e-9, 1e-9], dtype=F64, device=dev)
    else:
        fan_h = _fan(y1_h, x1_h, y2_h, x2_h, src_shift[1], src_shift[0],
                     theta_cntr_h)
    fan_v = _fan(y1_v, x1_v, y2_v, x2_v, src_shift[2], src_shift[0],
                 theta_cntr_v)
    mirrors = tuple(make_mirror(c, +1.0, m, a) for c, m, a in
                    zip(q_mis.unbind(0), centers, (ax1, ax2, ax3, ax4)))
    if two_mirror_only:
        mirrors = (mirrors[0], mirrors[2])
    return OpticalSystem(mirrors, s2f_middle, fan_h, fan_v, src_shift, valid)


def calibrate_uv(system: OpticalSystem, n_h: int = 9,
                 n_v: int = 9) -> OpticalSystem:
    """Set each mirror's Legendre-figure footprint from a traced probe fan.

    :func:`akbx_torch.surfaces.figure_height` evaluates the (n_u, n_v)
    Legendre modes on ``(local - uv_center) / uv_half``; the builders
    leave ``uv_half = 1`` (metres), under which a footprint of a few cm
    spans |u| <~ 0.02 and every mode looks like piston and a sliver of
    tilt.  This traces an ``n_h x n_v`` fan through the system (f64
    engine, no re-fan, no tilt removal) and sets ``uv_center`` and
    ``uv_half`` per mirror so that the modes span [-1, 1] over the
    illuminated aperture.  Where the footprint extends further along the
    local frame's row 2 than row 1 (the H mirrors, whose row 1 is the
    surface normal), rows 1 and 2 of ``axes`` are swapped, a
    ``torch.where`` on that condition.  Call it once after building and
    before installing figure errors."""
    from akbx_torch import trace as tr

    res = tr.run(system, n_h, n_v, defocus=0.0, exit_pupil_uniform=False,
                 tilt_correction=False)
    mirrors = []
    for m, pts in zip(system.mirrors, res.trace.points):
        axes = m.axes
        local = axes @ (pts - m.center[:, None])
        ext = torch.amax(local, dim=1) - torch.amin(local, dim=1)
        axes = torch.where(ext[2] > ext[1], axes[[0, 2, 1]], axes)
        local = axes @ (pts - m.center[:, None])
        lo = torch.amin(local, dim=1)
        hi = torch.amax(local, dim=1)
        uv_center = (hi[:2] + lo[:2]) / 2.0
        uv_half = torch.clamp_min((hi[:2] - lo[:2]) / 2.0, 1e-12)
        mirrors.append(m._replace(axes=axes, uv_center=uv_center,
                                  uv_half=uv_half))
    return system._replace(mirrors=tuple(mirrors))


def build_system(ordering, spec: AKBSpec, params: AlignParams,
                 **kw) -> OpticalSystem:
    """Dispatch on :class:`akbx_torch.config.WolterOrdering`."""
    from akbx_torch.config import WolterOrdering

    ordering = WolterOrdering(ordering)
    if ordering == WolterOrdering.WOLTER_3_1:
        return build_wolter_3_1(spec, params, **kw)
    if ordering == WolterOrdering.WOLTER_3_3_TANDEM:
        return build_wolter_3_3_tandem(spec, params, **kw)
    return build_wolter_3_3_alternating(spec, params, **kw)


# The reference's active tandem-variant constants (its HighNA branch).
WOLTER_3_3_TANDEM_DEFAULT = AKBSpec(
    a_hyp_v=72.9848, b_hyp_v=0.210324155665437,
    a_ell_v=0.3257, b_ell_v=0.0609957911371367,
    length_hyp_v=0.05, length_ell_v=0.316162847545838,
    theta1_v=4.13752081278497e-05,
    a_ell_h=0.101, b_ell_h=0.0261430961181383,
    a_hyp_h=73.206937469515, b_hyp_h=0.282536782718687,
    length_hyp_h=0.043, length_ell_h=0.0593351486637329,
    theta1_h=6.33460806383912e-05,
)

# The reference's active alternating-variant constants (HighNA branch).
WOLTER_3_3_ALT_DEFAULT = AKBSpec(
    a_hyp_v=72.96002945938, b_hyp_v=0.134829747201017,
    a_ell_v=0.442, b_ell_v=0.0607128830733533,
    length_hyp_v=0.115, length_ell_v=0.229790269646258,
    theta1_v=4.73536529533549e-05,
    a_ell_h=0.38125, b_ell_h=0.0397791317992322,
    a_hyp_h=73.018730871665, b_hyp_h=0.0970536727319812,
    length_hyp_h=0.25, length_ell_h=0.0653872838592807,
    theta1_h=5.6880350884129e-05,
)
