"""Batched sequential ray tracing through a mirror chain (port of
:mod:`akbx.trace`: the f64 engine and the ``precision="pallas"`` fast
engine, with ``exit_pupil_uniform=False``).

Rays are ``(3, N)`` f64 tensors; invalid rays carry a boolean mask.  The
fast engine traces one chief ray in f64 and every other ray as its exact
deviation from the chief in double-f32, on the kernels K1 (bounce chain)
and K2 (detector planes / OPL) of :mod:`akbx_torch.kernels.trace_kernel`;
between them, the tilt-removal angles are a masked mean over all rays.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from akbx_torch.core import geometry as geo
from akbx_torch.core import precision as pr
from akbx_torch.kernels import trace_kernel as tk
from akbx_torch.surfaces import intersect_and_reflect
from akbx_torch.systems import OpticalSystem

F32 = torch.float32
F64 = torch.float64


def masked_mean(x, valid, dim=None):
    w = valid.to(x.dtype)
    if dim is None:
        return torch.sum(x * w) / torch.clamp_min(torch.sum(w), 1.0)
    return (torch.sum(x * w, dim=dim)
            / torch.clamp_min(torch.sum(w, dim=dim), 1.0))


def ray_fan(angles_h: torch.Tensor, angles_v: torch.Tensor) -> torch.Tensor:
    """Direction fan (3, nV*nH), row-major with the vertical angle varying
    slowly: ``idx = iV * nH + iH``."""
    th, tv = torch.meshgrid(torch.tan(angles_h), torch.tan(angles_v),
                            indexing="xy")  # (nV, nH)
    d = torch.stack([torch.ones_like(th), th, tv]).reshape(3, -1)
    return geo.normalize(d)


def fan_angles(fan: torch.Tensor, n: int, mode: str = "uniform"):
    """``n`` equally spaced source angles across ``fan = (lo, hi)``
    (``jnp.linspace``'s formula: lo (1 - s) + hi s, last point exact)."""
    if mode != "uniform":
        raise NotImplementedError(
            f"fan_mode={mode!r} is not ported yet (ROADMAP Queue 1, item 8)")
    if n == 1:
        return fan[:1].clone()
    s = torch.arange(n - 1, dtype=F64, device=fan.device) / (n - 1)
    return torch.cat([fan[0] * (1 - s) + fan[1] * s, fan[1:2]])


class TraceResult(NamedTuple):
    points: tuple  # per-mirror surface points (3, N)
    directions: tuple  # incoming dir + per-mirror reflected dirs (3, N)
    normals: tuple  # per-mirror unit normals (3, N)
    segments: tuple  # per-leg path lengths (N,)
    valid: torch.Tensor  # (N,) bool

    @property
    def exit_rays(self):
        return self.directions[-1]

    @property
    def exit_points(self):
        return self.points[-1]


class LazyTraceResult:
    """A :class:`TraceResult` materialized in f64 on first access.

    The fast engine's f64 points, directions, normals and segments are
    ~1.3 GB at a 2048x2048 fan; most callers read only the deviation
    fields, so they are built only when an attribute is read.
    """

    def __init__(self, build):
        self._build = build
        self._result = None

    def materialize(self) -> TraceResult:
        if self._result is None:
            self._result = self._build()
            self._build = None
        return self._result

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        return getattr(self.materialize(), name)


def trace(system: OpticalSystem, rays: torch.Tensor,
          origins: torch.Tensor) -> TraceResult:
    """Sequential intersect->reflect through all mirrors, in f64."""
    points, dirs, normals, segs = [], [rays], [], []
    valid = torch.ones(rays.shape[1], dtype=torch.bool, device=rays.device)
    p, d = origins, rays
    for mirror in system.mirrors:
        pts, refl, n, seg, ok = intersect_and_reflect(mirror, d, p)
        valid = valid & ok
        points.append(pts)
        dirs.append(refl)
        normals.append(n)
        segs.append(seg)
        p, d = pts, refl
    return TraceResult(tuple(points), tuple(dirs), tuple(normals),
                       tuple(segs), valid)


def _deviation_constants(system: OpticalSystem, P, D, T, chief_p0):
    """Stacked per-mirror f64 chief constants of the deviation trace.

    Returns (Ms, bvecs, Ds, Dns, Ts, A_noms, Bp_noms, rhos, gCs, gAs,
    branches, Ps), each with leading dim n_mirrors.
    """
    Ps = torch.stack(P)                             # (nm, 3)
    coeffs_l = geo.shift(torch.stack([m.coeffs for m in system.mirrors]),
                         -Ps)
    Ms = geo.quadric_matrix(coeffs_l)[:, :3, :3]    # (nm, 3, 3)
    bvecs = coeffs_l[:, 6:9]
    Ds = torch.stack(D[:-1])                        # (nm, 3) incoming
    Dns = torch.stack(D[1:])                        # (nm, 3) outgoing
    Ts = torch.stack(T)                             # (nm,)
    prev_pts = torch.cat([chief_p0[:, 0][None], Ps[:-1]], dim=0)
    p_noms = prev_pts - Ps                          # (nm, 3)

    def quad(a, b):
        return torch.einsum("mi,mij,mj->m", a, Ms, b)

    def dot(a, b):
        return torch.einsum("mi,mi->m", a, b)

    A_noms = quad(Ds, Ds)
    B_noms = 2.0 * quad(p_noms, Ds) + dot(bvecs, Ds)
    C_noms = quad(p_noms, p_noms) + dot(bvecs, p_noms) + coeffs_l[:, 9]
    gCs = 2.0 * torch.einsum("mij,mj->mi", Ms, p_noms) + bvecs
    gAs = 2.0 * torch.einsum("mij,mj->mi", Ms, Ds)
    rhos = (A_noms * Ts + B_noms) * Ts + C_noms     # chief residuals (~0)
    Bp_noms = 2.0 * A_noms * Ts + B_noms
    branches = torch.stack([m.branch for m in system.mirrors])
    return (Ms, bvecs, Ds, Dns, Ts, A_noms, Bp_noms, rhos, gCs, gAs,
            branches, Ps)


class FastDevOut(NamedTuple):
    """Raw deviation-level outputs of the fast engine core: per-ray f32
    hi/lo double-words + f64 chief-ray scalars.  ``ddet``/``dtot`` are
    deviations of the (tilt-corrected) detector intersection / total OPL
    from the chief's; ``det_c``/``total_chief`` are the chief values."""

    dq_hi: torch.Tensor      # (3*nm, N) per-mirror intersection deviations
    dq_lo: torch.Tensor
    od_hi: torch.Tensor      # (3*nm, N) reflected-direction deviations
    od_lo: torch.Tensor
    dt_hi: torch.Tensor      # (nm, N) leg-length deviations
    dt_lo: torch.Tensor
    ddet_hi: torch.Tensor    # (3, N) focal-plane intersection deviations
    ddet_lo: torch.Tensor
    ddet2_hi: torch.Tensor   # (3, N) defocused-plane deviations
    ddet2_lo: torch.Tensor
    dqr_hi: torch.Tensor     # (3, N) tilt-rotated exit-point deviations
    dqr_lo: torch.Tensor
    ddr_hi: torch.Tensor     # (3, N) tilt-rotated exit-dir deviations
    ddr_lo: torch.Tensor
    dtot_hi: torch.Tensor    # (N,) OPL deviation to the focal plane
    dtot_lo: torch.Tensor
    dtot2_hi: torch.Tensor   # (N,) OPL deviation to the defocused plane
    dtot2_lo: torch.Tensor
    valid: torch.Tensor      # (N,) bool
    theta_y: torch.Tensor    # tilt-removal angles (f64 scalars)
    theta_z: torch.Tensor
    focus: torch.Tensor      # (3,) pre-tilt mean focus (rotation pivot)
    P_chief: torch.Tensor    # (nm, 3) chief hit points
    D_chief: torch.Tensor    # (nm, 3) chief outgoing directions
    T_chief: torch.Tensor    # (nm,) chief leg lengths
    P4r: torch.Tensor        # (3,) tilt-rotated chief exit point
    D4r: torch.Tensor        # (3,) tilt-rotated chief exit direction
    det_c: torch.Tensor      # (3,) chief focal-plane intersection
    det_c2: torch.Tensor     # (3,) chief defocused-plane intersection
    total_chief: torch.Tensor   # chief OPL to the focal plane
    total2_chief: torch.Tensor  # chief OPL to the defocused plane


def _tilt_stats(D4, dd4_32, valid, tilt: bool, tilt_mode: str):
    """Tilt-removal angles from exit-direction deviations:
    ``arctan(d_w / d_x)`` = the chief angle (f64) + ``arctan((u - v) /
    (1 + u v))`` with u the per-ray and v the chief slope, the small
    difference term in plain f32."""
    if not tilt:
        z = torch.zeros((), dtype=F64, device=D4.device)
        return z, z
    D432 = D4.to(F32)

    def dev_angle(comp):
        num = D432[0] * dd4_32[comp] - D432[comp] * dd4_32[0]
        den = D432[0] * (D432[0] + dd4_32[0])
        w = num / den
        u = (D432[comp] + dd4_32[comp]) / (D432[0] + dd4_32[0])
        v = D432[comp] / D432[0]
        return torch.atan(w / (1.0 + u * v))

    da_zx = dev_angle(2)
    da_yx = dev_angle(1)
    a_zx_c = torch.atan(D4[2] / D4[0])
    a_yx_c = torch.atan(D4[1] / D4[0])
    if tilt_mode == "extremes":
        def mid(a):
            return 0.5 * (torch.min(torch.where(valid, a, float("inf")))
                          + torch.max(torch.where(valid, a, -float("inf"))))

        m_zx, m_yx = mid(da_zx), mid(da_yx)
    else:
        m_zx = masked_mean(da_zx, valid)
        m_yx = masked_mean(da_yx, valid)
    theta_y = -(a_zx_c + m_zx.to(F64))
    theta_z = a_yx_c + m_yx.to(F64)
    return theta_y, theta_z


def _pre_tilt_focus(P4, D4, det_x, dq4_32, dd4_32, valid):
    """Masked mean of the pre-tilt focal-plane intersections (the tilt
    rotation pivot), chief + f32 deviation mean."""
    t_c0 = (det_x - P4[0]) / D4[0]
    det_c0 = P4 + t_c0 * D4
    D432 = D4.to(F32)
    tc032 = t_c0.to(F32)
    den = D432[0] + dd4_32[0]
    dt0 = -(dq4_32[0] + tc032 * dd4_32[0]) / den
    ddet0 = dq4_32 + tc032 * dd4_32 + dt0 * (D432[:, None] + dd4_32)
    return det_c0 + masked_mean(ddet0, valid[None, :], dim=1).to(F64)


def _tilt_rotation(theta_y, theta_z):
    """R = Ry(-theta_y) @ Rz(-theta_z), the tilt-removal rotation."""
    ey = torch.tensor([0.0, 1.0, 0.0], dtype=F64, device=theta_y.device)
    ez = torch.tensor([0.0, 0.0, 1.0], dtype=F64, device=theta_y.device)
    return geo.rodrigues(ey, -theta_y) @ geo.rodrigues(ez, -theta_z)


def _det_plane_scalars(P4r, D4r, det_x):
    """Chief detector-plane constants: (t_c, det_c, L)."""
    t_c = (det_x - P4r[0]) / D4r[0]
    det_c = P4r + t_c * D4r
    L = torch.abs(t_c) * torch.sqrt(torch.sum(D4r * D4r))
    return t_c, det_c, L


def _fast_scalars(system, rays, origins, chief_idx):
    """Chief trace + deviation constants."""
    chief_d0 = rays[:, chief_idx:chief_idx + 1]
    chief_p0 = origins[:, chief_idx:chief_idx + 1]
    chief = trace(system, chief_d0, chief_p0)
    P = [p[:, 0] for p in chief.points]
    D = [d[:, 0] for d in chief.directions]
    T = [s[0] for s in chief.segments]
    consts64 = _deviation_constants(system, P, D, T, chief_p0)
    return chief_d0, chief_p0, consts64


def _fast_post_scalars(consts64, det_x, det_x2, theta_y, theta_z, focus,
                       tilt: bool):
    """Rotation + per-plane chief constants of the detector stage."""
    Ts = consts64[4]
    P4 = consts64[-1][-1]
    D4 = consts64[3][-1]
    if tilt:
        R = _tilt_rotation(theta_y, theta_z)
        P4r = R @ (P4 - focus) + focus
        D4r = R @ D4
    else:
        R = torch.eye(3, dtype=F64, device=P4.device)
        P4r, D4r = P4, D4
    t_c, det_c, L = _det_plane_scalars(P4r, D4r, det_x)
    t_c2, det_c2, L2 = _det_plane_scalars(P4r, D4r, det_x2)
    T_sum = torch.sum(Ts)
    return (R, P4r, D4r, t_c, det_c, L, t_c2, det_c2, L2,
            T_sum + L, T_sum + L2)


def _fast_devs_forward(system, rays, origins, det_x, det_x2, chief_idx: int,
                       tilt: bool, tilt_mode: str) -> FastDevOut:
    """Deviation-level fast engine: K1, the tilt reductions, K2 (both
    detector planes in one launch)."""
    chief_d0, chief_p0, consts64 = _fast_scalars(system, rays, origins,
                                                 chief_idx)
    (Ms, bvecs, Ds, Dns, Ts, A_noms, Bp_noms, rhos, gCs, gAs, branches,
     Ps) = consts64
    n_mirr = Ps.shape[0]
    consts = tk.pack_consts(Ms, gCs, gAs, Ds, Dns, Ts, A_noms, Bp_noms,
                            rhos, branches, bvecs)
    (dq_hi, dq_lo, od_hi, od_lo, dt_hi, dt_lo, dsum_hi, dsum_lo,
     val) = tk.trace_deviation(consts, origins - chief_p0, rays - chief_d0,
                               n_mirr)
    valid = val[0] > 0.5
    s = slice(3 * (n_mirr - 1), 3 * n_mirr)
    q4_hi, q4_lo = dq_hi[s], dq_lo[s]
    d4_hi, d4_lo = od_hi[s], od_lo[s]
    P4, D4 = Ps[-1], Dns[-1]

    theta_y, theta_z = _tilt_stats(D4, d4_hi, valid, tilt, tilt_mode)
    focus = _pre_tilt_focus(P4, D4, det_x, q4_hi, d4_hi, valid)
    (R, P4r, D4r, t_c, det_c, L, t_c2, det_c2, L2, total_chief,
     total2_chief) = _fast_post_scalars(consts64, det_x, det_x2,
                                        theta_y, theta_z, focus, tilt)

    dcon = torch.cat([tk.pack_det_consts(R, D4r, t_c, L),
                      tk.pack_det_consts(R, D4r, t_c2, L2)])
    (ddet_hi, ddet_lo, dqr_hi, dqr_lo, ddr_hi, ddr_lo, dtot_hi,
     dtot_lo) = tk.detector(dcon, q4_hi, q4_lo, d4_hi, d4_lo, dsum_hi,
                            dsum_lo)
    return FastDevOut(dq_hi, dq_lo, od_hi, od_lo, dt_hi, dt_lo,
                      ddet_hi[0], ddet_lo[0], ddet_hi[1], ddet_lo[1],
                      dqr_hi, dqr_lo, ddr_hi, ddr_lo,
                      dtot_hi[0], dtot_lo[0], dtot_hi[1], dtot_lo[1], valid,
                      theta_y, theta_z, focus, Ps, Dns, Ts,
                      P4r, D4r, det_c, det_c2, total_chief, total2_chief)


class _FastDevs(torch.autograd.Function):
    """The fast engine as one autograd node.  Its backward (autograd of a
    plain-f32 twin, ``akbx.trace._fast_devs_f32``) is not ported yet, so
    it raises instead of returning a wrong gradient."""

    @staticmethod
    def forward(ctx, system, rays, origins, det_x, det_x2, chief_idx, tilt,
                tilt_mode, *system_tensors):
        return tuple(_fast_devs_forward(system, rays, origins, det_x, det_x2,
                                        chief_idx, tilt, tilt_mode))

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(
            "the backward of the fast engine (the plain-f32 twin "
            "_fast_devs_f32 + _dev32_scan) is not ported yet "
            "(ROADMAP Queue 1, item 6)")


def _fast_devs(system, rays, origins, det_x, det_x2, chief_idx: int,
               tilt: bool, tilt_mode: str) -> FastDevOut:
    # the system's tensors go in as arguments too, so that a gradient
    # through any of them reaches _FastDevs.backward
    system_tensors = [t for m in system.mirrors for t in m]
    return FastDevOut(*_FastDevs.apply(system, rays, origins, det_x, det_x2,
                                       chief_idx, tilt, tilt_mode,
                                       *system_tensors))


def _f64_of(hi, lo):
    return hi.to(F64) + lo.to(F64)


def run_fast(system: OpticalSystem, rays, origins, det_x, det_x2,
             chief_idx: int | None = None, tilt_correction: bool = True,
             tilt_mode: str = "mean"):
    """The precision='pallas' engine pass (trace through OPL).

    Returns a dict with keys: detcenter, detcenter2, total, total2, valid,
    theta_y, theta_z, focus, trace (a :class:`LazyTraceResult`), w32
    (demeaned OPL deviation, f32), w32_2, ddet32 (f32 detcenter
    deviations).
    """
    if chief_idx is None:
        chief_idx = rays.shape[1] // 2
    d = _fast_devs(system, rays, origins, det_x, det_x2, int(chief_idx),
                   bool(tilt_correction), str(tilt_mode))

    detcenter = d.det_c[:, None] + _f64_of(d.ddet_hi, d.ddet_lo)
    detcenter2 = d.det_c2[:, None] + _f64_of(d.ddet2_hi, d.ddet2_lo)
    total = d.total_chief + _f64_of(d.dtot_hi, d.dtot_lo)
    total2 = d.total2_chief + _f64_of(d.dtot2_hi, d.dtot2_lo)

    # f32 deviation-form wavefront fields (demeaned over valid rays)
    mh = masked_mean(d.dtot_hi, d.valid)
    ml = masked_mean(d.dtot_lo, d.valid)
    w32 = (d.dtot_hi - mh) + (d.dtot_lo - ml)
    mh2 = masked_mean(d.dtot2_hi, d.valid)
    ml2 = masked_mean(d.dtot2_lo, d.valid)
    w32_2 = (d.dtot2_hi - mh2) + (d.dtot2_lo - ml2)

    def materialize() -> TraceResult:
        n_mirr = d.P_chief.shape[0]
        points, dirs, normals, segs = [], [rays], [], []
        for m in range(n_mirr):
            rows = slice(3 * m, 3 * m + 3)
            pts = d.P_chief[m][:, None] + _f64_of(d.dq_hi[rows],
                                                  d.dq_lo[rows])
            points.append(pts)
            dirs.append(d.D_chief[m][:, None] + _f64_of(d.od_hi[rows],
                                                        d.od_lo[rows]))
            normals.append(geo.surface_normal(system.mirrors[m].coeffs, pts))
            segs.append(d.T_chief[m] + _f64_of(d.dt_hi[m], d.dt_lo[m]))
        # the tilt-corrected exit point/dir replace the last mirror's
        points[-1] = d.P4r[:, None] + _f64_of(d.dqr_hi, d.dqr_lo)
        dirs[-1] = d.D4r[:, None] + _f64_of(d.ddr_hi, d.ddr_lo)
        return TraceResult(tuple(points), tuple(dirs), tuple(normals),
                           tuple(segs), d.valid)

    return {
        "detcenter": detcenter, "detcenter2": detcenter2,
        "total": total, "total2": total2, "valid": d.valid,
        "theta_y": d.theta_y, "theta_z": d.theta_z, "focus": d.focus,
        "trace": LazyTraceResult(materialize), "w32": w32, "w32_2": w32_2,
        "ddet32": d.ddet_hi,
    }


def detector_points(result: TraceResult, x_plane) -> torch.Tensor:
    """Intersect exit rays with the plane x = x_plane."""
    return geo.plane_intersect(geo.detector_plane(x_plane), result.exit_rays,
                               result.exit_points)


def tilt_correct(result: TraceResult, detcenter: torch.Tensor,
                 mode: str = "mean"):
    """Remove the mean exit-beam tilt: rotate exit rays and exit points
    about the approximate focus so the beam axis is +x.  Returns
    (new_exit_rays, new_exit_points, theta_y, theta_z, focus_apprx).
    ``mode``: ``"mean"`` (mean of the ray angles) or ``"extremes"``
    (midpoint of the extreme ray angles)."""
    angle = result.exit_rays
    v = result.valid
    a_zx = torch.atan(angle[2] / angle[0])
    a_yx = torch.atan(angle[1] / angle[0])
    if mode == "extremes":
        inf = float("inf")
        theta_y = -0.5 * (torch.min(torch.where(v, a_zx, inf))
                          + torch.max(torch.where(v, a_zx, -inf)))
        theta_z = 0.5 * (torch.min(torch.where(v, a_yx, inf))
                         + torch.max(torch.where(v, a_yx, -inf)))
    else:
        theta_y = -masked_mean(a_zx, v)
        theta_z = masked_mean(a_yx, v)
    focus_apprx = masked_mean(detcenter, v[None, :], dim=1)
    rays2 = geo.rotate_vectors_yz(result.exit_rays, -theta_y, -theta_z)
    pts2 = geo.rotate_points_about(result.exit_points, focus_apprx,
                                   -theta_y, -theta_z)
    return rays2, pts2, theta_y, theta_z, focus_apprx


class EngineResult(NamedTuple):
    """Everything the analysis layers need from one full engine run."""

    trace: TraceResult  # a LazyTraceResult on the fast path
    detcenter: torch.Tensor  # focal-plane intersections (3, N), tilt-corrected
    detcenter2: torch.Tensor  # defocused-plane intersections (3, N)
    total_dist: torch.Tensor  # OPL to focal plane (N,)
    total_dist2: torch.Tensor  # OPL to defocused plane (N,)
    wave2: torch.Tensor  # wavefront error on defocused plane [nm] (N,)
    valid: torch.Tensor
    theta_y: torch.Tensor
    theta_z: torch.Tensor
    focus_apprx: torch.Tensor
    rand_p0h: torch.Tensor
    rand_p0v: torch.Tensor
    # deviation-form f32 fields (precision='pallas' only, else None):
    # demeaned OPL deviations [m] (focal / defocused plane) and detcenter
    # deviations from the chief
    w32: torch.Tensor | None = None
    ddet32: torch.Tensor | None = None
    w32_2: torch.Tensor | None = None


def _wave2(detcenter, detcenter2, total2, v):
    """Wavefront on the defocused plane [nm]: OPL error minus the
    reference sphere about the mean focus."""
    mean_focus = masked_mean(detcenter, v[None, :], dim=1)
    dist_err2 = (total2 - masked_mean(total2, v)) * 1e9
    sph = torch.sqrt(torch.sum((detcenter2 - mean_focus[:, None]) ** 2,
                               dim=0)) * 1e9
    return dist_err2 - sph


def run(system: OpticalSystem, n_h: int, n_v: int, defocus,
        defocus_wave=1e-3, exit_pupil_uniform: bool = True,
        tilt_correction: bool = True, ray_sharding=None,
        uniform_stage: int = -1, precision: str = "f64",
        tilt_mode: str = "mean", fan_mode: str = "uniform") -> EngineResult:
    """Full engine pass: fan -> trace -> tilt removal -> detector planes
    -> OPL -> wavefront, on the device of ``system``.

    Ported: ``precision="pallas"`` (the deviation kernels) and
    ``precision="f64"``, both with ``exit_pupil_uniform=False``.  Every
    other combination raises ``NotImplementedError`` naming its ROADMAP
    item.  ``uniform_stage`` only applies to the exit-pupil re-fan.
    """
    if exit_pupil_uniform:
        raise NotImplementedError(
            "exit_pupil_uniform=True is not ported yet (ROADMAP Queue 1, "
            "item 8); pass exit_pupil_uniform=False")
    if ray_sharding is not None:
        raise NotImplementedError(
            "ray sharding is not ported yet (ROADMAP Queue 1, item 14)")
    if precision == "df32":
        raise NotImplementedError(
            "precision='df32' is not ported yet (ROADMAP Queue 1, item 8)")
    if precision not in ("f64", "pallas"):
        raise ValueError(f"unknown precision {precision!r}")
    if any(tuple(m.fig_coeffs.shape) != (1, 1) for m in system.mirrors):
        raise NotImplementedError(
            "figure errors are not ported yet (ROADMAP Queue 1, item 3)")

    rand_p0h = fan_angles(system.fan_h, n_h, mode=fan_mode)
    rand_p0v = fan_angles(system.fan_v, n_v, mode=fan_mode)
    src = system.source[:, None].expand(3, n_h * n_v)
    rays = ray_fan(rand_p0h, rand_p0v)
    det_x = system.s2f_middle + defocus

    if precision == "pallas":
        out = run_fast(system, rays, src, det_x, det_x + defocus_wave,
                       tilt_correction=tilt_correction, tilt_mode=tilt_mode)
        v = out["valid"]
        wave2 = _wave2(out["detcenter"], out["detcenter2"], out["total2"], v)
        return EngineResult(out["trace"], out["detcenter"],
                            out["detcenter2"], out["total"], out["total2"],
                            wave2, v, out["theta_y"], out["theta_z"],
                            out["focus"], rand_p0h, rand_p0v,
                            out["w32"], out["ddet32"], out["w32_2"])

    result = trace(system, rays, src)
    detcenter = detector_points(result, det_x)
    if tilt_correction:
        rays2, pts2, theta_y, theta_z, focus_apprx = tilt_correct(
            result, detcenter, mode=tilt_mode)
        result = result._replace(
            points=result.points[:-1] + (pts2,),
            directions=result.directions[:-1] + (rays2,),
        )
        detcenter = detector_points(result, det_x)
    else:
        theta_y = torch.zeros((), dtype=F64, device=rays.device)
        theta_z = torch.zeros((), dtype=F64, device=rays.device)
        focus_apprx = masked_mean(detcenter, result.valid[None, :], dim=1)
    detcenter2 = detector_points(result, det_x + defocus_wave)

    # OPL with compensated accumulation
    d_last = torch.sqrt(torch.sum((detcenter - result.exit_points) ** 2,
                                  dim=0))
    d_last2 = torch.sqrt(torch.sum((detcenter2 - result.exit_points) ** 2,
                                   dim=0))
    total = pr.sum_segments(list(result.segments) + [d_last])
    total2 = pr.sum_segments(list(result.segments) + [d_last2])
    v = result.valid
    wave2 = _wave2(detcenter, detcenter2, total2, v)
    return EngineResult(result, detcenter, detcenter2, total, total2, wave2,
                        v, theta_y, theta_z, focus_apprx, rand_p0h, rand_p0v)


def spot_size(detcenter: torch.Tensor, valid: torch.Tensor):
    """Masked std of the spot in (horizontal, vertical)."""
    w = valid.to(detcenter.dtype)
    n = torch.clamp_min(torch.sum(w), 1.0)
    mu_y = torch.sum(detcenter[1] * w) / n
    mu_z = torch.sum(detcenter[2] * w) / n
    sy = torch.sqrt(torch.sum(w * (detcenter[1] - mu_y) ** 2) / n)
    sz = torch.sqrt(torch.sum(w * (detcenter[2] - mu_z) ** 2) / n)
    return sy, sz
