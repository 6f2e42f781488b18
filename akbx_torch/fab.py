"""Fabrication and metrology tooling (port of :mod:`akbx.fab`): mirror
profiles for machining.

* analytic conic profiles rotated into the machining frame, offset,
  resampled to a fixed pitch, margin-extrapolated with parabolas,
  max-envelope merged and exported as CSV at the raw and 0.1 mm pitch
  (the reference's ``AKB_calc_rotate.py``);
* traced point-cloud handling: the canonical frame of a placed quadric,
  Newell quad normals, vector-to-vector rotations, side profiles
  (``surfacedetailAKB.py``);
* two-profile cross-check: common-grid interpolation, difference, linear
  detrend (``compareCSV.py``).

The output is CSV for the machine shop, so this runs in numpy on the host,
as in akbx.  Every function takes tensors on any device (or array-likes)
and converts them to numpy at its boundary; the results are numpy.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def _numpy_of(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if type(x) in (list, tuple):
        return type(x)(_numpy_of(v) for v in x)
    return x


def _on_host(fn):
    """Convert every tensor argument (also inside a list or tuple) to
    numpy before ``fn`` runs."""
    @functools.wraps(fn)
    def wrapped(*args, **kw):
        return fn(*(_numpy_of(a) for a in args),
                  **{k: _numpy_of(v) for k, v in kw.items()})

    return wrapped


# --- conic profiles (reference AKB_calc_rotate.py:4-7) ---

@_on_host
def hyperbola_profile(a, b, x0, x):
    """y of the hyperbola branch at axial position x (vertex frame x0)."""
    return b * np.sqrt(((x - x0) / a) ** 2 - 1)


@_on_host
def ellipse_profile(a, b, x0, x):
    return b * np.sqrt(1 - ((x - x0) / a) ** 2)


@_on_host
def rotation_2d(x, y, angle_rad):
    """Parity: ``rotation_2D`` (AKB_calc_rotate.py:9-12)."""
    c, s = np.cos(angle_rad), np.sin(angle_rad)
    return x * c - y * s, x * s + y * c


@_on_host
def calc_theta3(x, y, a):
    """Parity: ``calc_theta3`` (AKB_calc_rotate.py:13-14)."""
    return np.arcsin(y / (np.sqrt(x**2 + y**2) - 2 * a))


@_on_host
def conic_radius_at_angle(a, b, theta3, x0, hyperbola: bool = False):
    """Polar-angle -> radius quadratic for ellipse/hyperbola.

    Parity: ``calc_ell_theta``/``calc_hyp_theta``
    (AKB_calc_rotate.py:24-46); returns both roots (stable form).
    """
    sgn = -1.0 if hyperbola else 1.0
    A = np.cos(theta3) ** 2 / a**2 + sgn * np.sin(theta3) ** 2 / b**2
    B = -2 * x0 * np.cos(theta3) / a**2
    C = x0**2 / a**2 - 1
    D = B**2 - 4 * A * C
    if np.any(D < 0):
        raise ValueError("no real intersection at this angle")
    sq = np.sqrt(D)
    q = -0.5 * (B + np.sign(B + (B == 0)) * sq)
    r1 = np.where(B >= 0, C / q, q / A)
    r2 = np.where(B >= 0, q / A, C / q)
    return r1, r2


@_on_host
def extrapolate_parabola(x0, y0, x1, y1, dydx1, xx):
    """Parabola through (x1,y1) with slope dydx1 there and apex value at x0.

    Parity: ``extrapolate_parabola`` (AKB_calc_rotate.py:16-19).
    """
    a = dydx1 / (2 * (x1 - x0))
    return a * (xx - x0) ** 2 - a * (x1 - x0) ** 2 + y1


@_on_host
def extrapolate_linear(x0, y0, x1, y1, dydx1, xx):
    """Parity: ``extrapolate_linear`` (AKB_calc_rotate.py:20-23)."""
    return dydx1 * (xx - x1) + y1


@_on_host
def interp_nan(arr: np.ndarray) -> np.ndarray:
    """Fill NaNs by linear interpolation; edge NaNs take the nearest valid
    value.  Parity: ``interp_nan`` (AKB_calc_rotate.py:47-77)."""
    arr = np.array(arr, dtype=float)
    idx = np.arange(arr.size)
    ok = ~np.isnan(arr)
    if not ok.any():
        return arr
    first, last = idx[ok][0], idx[ok][-1]
    arr[:first] = arr[first]
    arr[last + 1:] = arr[last]
    ok = ~np.isnan(arr)
    arr[~ok] = np.interp(idx[~ok], idx[ok], arr[ok])
    return arr


@_on_host
def merge_max(segments) -> tuple[np.ndarray, np.ndarray]:
    """Max-envelope merge of (x, y) profile segments onto the pitch of the
    first segment.  Parity: ``merge_array`` (AKB_calc_rotate.py:78-105) —
    vectorized (nearest-sample max instead of the reference's per-point
    python loop), NaN gaps interpolated.
    """
    xs = [np.asarray(x) for x, _ in segments]
    ys = [np.asarray(y) for _, y in segments]
    xmin = min(np.nanmin(x) for x in xs)
    xmax = max(np.nanmax(x) for x in xs)
    pitch = xs[0][1] - xs[0][0]
    x_m = np.arange(xmin, xmax, pitch)
    y_m = np.full_like(x_m, -np.inf)
    covered = np.zeros_like(x_m, dtype=bool)
    for x, y in zip(xs, ys):
        inside = (x_m >= np.nanmin(x)) & (x_m <= np.nanmax(x))
        nearest = np.clip(np.searchsorted(x, x_m), 0, x.size - 1)
        prev = np.clip(nearest - 1, 0, x.size - 1)
        pick = np.where(np.abs(x[prev] - x_m) <= np.abs(x[nearest] - x_m),
                        prev, nearest)
        y_here = y[pick]
        y_m = np.where(inside, np.maximum(y_m, y_here), y_m)
        covered |= inside
    y_m = np.where(covered, y_m, np.nan)
    if np.isnan(y_m).any():
        y_m = interp_nan(y_m)
    return x_m, y_m


@_on_host
def machining_profile(profile_fn, center_x, length: float, num: int = 100000,
                      pre_margin=(0.012, 0.02), keep_margin=(0.001, 0.015),
                      extra_margin: float = 0.014, height_margin: float = 0.5,
                      pitch: float = 1e-5):
    """Rotate a mirror profile to the machining frame + margins.

    The reference pipeline for each mirror (AKB_calc_rotate.py:140-223):
    sample the conic, rotate so the chord is horizontal, recentre/offset,
    resample at fixed pitch over [start-keep_u, end+keep_l], parabola-
    extrapolate an approach ramp of ``extra_margin`` falling by
    ``height_margin``, max-merge.

    ``profile_fn(x) -> y`` in the conic's canonical frame.
    Returns dict with rotated raw (x, y), merged (x, y), rotation angle.
    """
    xx = np.linspace(-length / 2, length / 2, num) + center_x
    yy = _numpy_of(profile_fn(xx))
    rot = -np.arctan((yy[-1] - yy[0]) / (xx[-1] - xx[0]))
    xr, yr = rotation_2d(xx, yy, rot)

    xx_m = np.linspace(-length / 2 - pre_margin[0],
                       length / 2 + pre_margin[1], num) + center_x
    yy_m = _numpy_of(profile_fn(xx_m))
    xrm, yrm = rotation_2d(xx_m, yy_m, rot)

    x_off = (xr[0] + xr[-1]) / 2
    y_off = np.nanmax(yr)
    xr, yr = xr - x_off, yr - y_off
    xrm, yrm = xrm - x_off, yrm - y_off

    x_res = np.arange(round(np.min(xrm), 5), round(np.max(xrm), 5), pitch)
    y_res = np.interp(x_res, xrm, yrm)
    mask = (x_res > (np.nanmin(xr) - keep_margin[0])) & \
           (x_res < (np.nanmax(xr) + keep_margin[1]))
    x_res, y_res = x_res[mask], y_res[mask]

    x_ext = np.arange(np.min(x_res) - extra_margin, np.min(x_res), pitch)
    dydx = (y_res[1] - y_res[0]) / (x_res[1] - x_res[0])
    y_ext = extrapolate_parabola(x_res[0] - extra_margin,
                                 y_res[0] - height_margin,
                                 x_res[0], y_res[0], dydx, x_ext)

    x_merged, y_merged = merge_max([(x_res, y_res), (x_ext, y_ext)])
    return {"x_raw": xr, "y_raw": yr, "x_merged": x_merged,
            "y_merged": y_merged, "rotation": rot}


@_on_host
def wolter1_combined_profile(a_ell, b_ell, a_hyp, b_hyp, theta1,
                             ell_length, num: int = 100000,
                             pre_margin=(0.5, 0.018), keep_margin: float = 0.001,
                             gap_margin: float = 0.015,
                             extra_margin: float = 0.020,
                             height_margin: float = 0.5, pitch: float = 1e-5):
    """Combined ell+hyp machining profile of the Wolter-I H pair.

    Re-derivation of the reference's "1型" export block
    (AKB_calc_rotate.py:329-497): sample the ellipse about its chief-ray
    station, chain each sample to the hyperbola through the shared focus
    angle theta3 (arccos form :362-365, polar quadratic :371-376), rotate
    BOTH mirrors by the single length-weighted chord rotation x1.2
    (:381-389), offset to the (ell-start + hyp-end)/2 midpoint, flip y,
    resample on a common pitch, take the per-sample max envelope across
    the inter-mirror gap, and parabola-ramp both ends.

    Returns dict with the rotated per-mirror profiles, the merged combined
    profile, and the rotation angle.
    """
    f_ell = np.sqrt(a_ell**2 - b_ell**2)
    f_hyp = np.sqrt(a_hyp**2 + b_hyp**2)

    xc_ell, _ = conic_radius_at_angle(a_ell, b_ell, theta1, f_ell)

    def ell_chain(xx):
        yy = ellipse_profile(a_ell, b_ell, f_ell, xx)
        l1 = np.sqrt(xx**2 + yy**2)
        theta3 = np.arccos((2 * f_ell - xx) / (2 * a_ell - l1))
        l3, _ = conic_radius_at_angle(a_hyp, b_hyp, theta3, f_hyp,
                                      hyperbola=True)
        xh = 2 * f_ell - l3 * np.cos(theta3)
        yh = l3 * np.sin(theta3)
        return yy, xh, yh

    xx_e = np.linspace(-ell_length / 2, ell_length / 2, num) + xc_ell
    yy_e, xx_h, yy_h = ell_chain(xx_e)
    xx_em = np.linspace(-ell_length / 2 - pre_margin[0],
                        ell_length / 2 + pre_margin[1], num) + xc_ell
    yy_em, xx_hm, yy_hm = ell_chain(xx_em)

    rot_h = -np.arctan((yy_h[-1] - yy_h[0]) / (xx_h[-1] - xx_h[0]))
    rot_e = -np.arctan((yy_e[-1] - yy_e[0]) / (xx_e[-1] - xx_e[0]))
    len_h = xx_h[0] - xx_h[-1]
    len_e = xx_e[-1] - xx_e[0]
    # the reference's empirical 1.2x length-weighted blend (:388)
    rot_w = (rot_h * len_h + rot_e * len_e) / (len_h + len_e) * 1.2

    xr_e, yr_e = rotation_2d(xx_e, yy_e, rot_w)
    xr_h, yr_h = rotation_2d(xx_h, yy_h, rot_w)
    xr_em, yr_em = rotation_2d(xx_em, yy_em, rot_w)
    xr_hm, yr_hm = rotation_2d(xx_hm, yy_hm, rot_w)

    x_off = (xr_e[0] + xr_h[-1]) / 2
    y_off = np.nanmin(yr_e)
    xr_e, xr_h, xr_em, xr_hm = (v - x_off for v in (xr_e, xr_h, xr_em, xr_hm))
    yr_e, yr_h, yr_em, yr_hm = (y_off - v for v in (yr_e, yr_h, yr_em, yr_hm))

    start = round(float(np.min(xr_em)), 5)
    stop = round(float(np.max(xr_hm)), 5)
    x_grid = np.arange(start, stop, pitch)
    y_res_e = np.interp(x_grid, xr_em, yr_em)
    y_res_h = np.interp(x_grid, xr_hm[::-1], yr_hm[::-1])

    m_e = (x_grid > (np.nanmin(xr_e) - keep_margin)) & \
          (x_grid < (np.nanmax(xr_e) + gap_margin))
    m_h = (x_grid > (np.nanmin(xr_h) - gap_margin)) & \
          (x_grid < (np.nanmax(xr_h) + keep_margin))
    x_c, y_c = merge_max([(x_grid[m_e], y_res_e[m_e]),
                          (x_grid[m_h], y_res_h[m_h])])

    x_ext_u = np.arange(x_c[0] - extra_margin, x_c[0], pitch)
    dydx = (y_c[1] - y_c[0]) / (x_c[1] - x_c[0])
    y_ext_u = extrapolate_parabola(x_c[0] - extra_margin,
                                   y_c[0] + height_margin,
                                   x_c[0], y_c[0], dydx, x_ext_u)
    x_ext_l = np.arange(x_c[-1], x_c[-1] + extra_margin, pitch)
    dydx = (y_c[-1] - y_c[-2]) / (x_c[-1] - x_c[-2])
    # apex follows the reference's own choice (:456): last ramp sample
    # + extra_margin, not last profile sample + extra_margin
    y_ext_l = extrapolate_parabola(x_ext_l[-1] + extra_margin,
                                   y_c[-1] + height_margin,
                                   x_c[-1], y_c[-1], dydx, x_ext_l)

    x_m, y_m = merge_max([(x_c, y_c), (x_ext_u, y_ext_u),
                          (x_ext_l, y_ext_l)])
    return {"x_ell": xr_e, "y_ell": yr_e, "x_hyp": xr_h, "y_hyp": yr_h,
            "x_merged": x_m, "y_merged": y_m, "rotation": rot_w,
            "x_ell_raw": xx_e, "y_ell_raw": yy_e,
            "x_hyp_raw": xx_h, "y_hyp_raw": yy_h}


@_on_host
def export_profile_csv(path: str, x_m, y_m, pitch_mm: float | None = None):
    """CSV export in the reference's mm format (header 'x(mm),y(mm)').

    With ``pitch_mm`` the profile is resampled to that pitch first
    (reference's 0.1 mm export, AKB_calc_rotate.py:213-216).
    """
    x_mm = np.asarray(x_m) * 1e3
    y_mm = np.asarray(y_m) * 1e3
    if pitch_mm is not None:
        xq = np.arange(np.nanmin(x_mm), np.nanmax(x_mm), pitch_mm)
        y_mm = np.interp(xq, x_mm, y_mm)
        x_mm = xq
    np.savetxt(path, np.column_stack((x_mm, y_mm)), fmt="%.6f",
               header="x(mm),y(mm)", delimiter=",")
    return path


# --- traced point-cloud tooling (surfacedetailAKB.py) ---

@_on_host
def quadric_principal_frame(coeffs, tol: float = 1e-9):
    """Recover a placed conic's canonical frame from its quadric.

    The capability behind ``surfacedetailAKB.py``'s un-rotation loop
    (:235-246): that script undoes the engine's placement with hardcoded
    yaw/roll angles; here the frame is recovered from the quadric itself
    (eigen-decomposition of the quadratic part), so ANY placed mirror can
    be brought back to its canonical frame without engine internals.

    Handles both surfaces of revolution (isolated eigenvalue = axis) and
    the engine's cylindrical conics ('xz'-plane hyperbola/ellipse with no
    y^2 term -> a null eigenvalue along the extrusion direction).

    Returns dict with ``center`` (minimal-norm for cylinders — the center
    is only defined up to the null direction), ``axis`` (conic long axis),
    ``profile_dir`` (unit direction of the sag coordinate; None for a
    surface of revolution), ``null`` mask, eigenvalues ``w``.
    """
    c = np.asarray(coeffs, dtype=float)
    Q = np.array([[c[0], c[3] / 2, c[4] / 2],
                  [c[3] / 2, c[1], c[5] / 2],
                  [c[4] / 2, c[5] / 2, c[2]]])
    g = np.array([c[6], c[7], c[8]]) / 2
    w, V = np.linalg.eigh(Q)
    null = np.abs(w) < tol * np.abs(w).max()
    center = -np.linalg.lstsq(Q, g, rcond=tol)[0]

    if null.any():
        live = np.where(~null)[0]
        # the conic long axis is the flatter principal direction
        # (|1/a^2| << |1/b^2| for every grazing mirror here)
        i_axis = live[np.argmin(np.abs(w[live]))]
        i_prof = live[np.argmax(np.abs(w[live]))]
        profile_dir = V[:, i_prof]
    else:
        # isolated eigenvalue = revolution axis: pick i whose exclusion
        # leaves the closest-together pair
        pair_gap = [abs(w[1] - w[2]), abs(w[0] - w[2]), abs(w[0] - w[1])]
        i_axis = int(np.argmin(pair_gap))
        profile_dir = None
    axis = V[:, i_axis]
    if axis[np.argmax(np.abs(axis))] < 0:
        axis = -axis
    return {"center": center, "axis": axis, "profile_dir": profile_dir,
            "null": null, "w": w}


@_on_host
def canonical_conic_profile(points, coeffs):
    """Project a traced (3,N) cloud into its conic's canonical frame.

    Returns (x_canonical, r): x along the recovered conic axis from the
    conic center, r the unsigned sag coordinate (distance from the axis
    for a surface of revolution; the in-plane coordinate for a
    cylindrical conic) — directly comparable to
    :func:`hyperbola_profile` / :func:`ellipse_profile` with ``x0=0``.
    """
    frame = quadric_principal_frame(coeffs)
    p = np.asarray(points, dtype=float) - frame["center"][:, None]
    x = frame["axis"] @ p
    if np.mean(x) < 0:
        x = -x
    if frame["profile_dir"] is not None:
        r = np.abs(frame["profile_dir"] @ p)
    else:
        perp = p - frame["axis"][:, None] * (frame["axis"] @ p)[None, :]
        r = np.linalg.norm(perp, axis=0)
    return x, r

@_on_host
def newell_normal(p0, p1, p2, p3) -> np.ndarray:
    """Unit normal of a quad by Newell's method.

    Parity: ``normal_from_quad`` (surfacedetailAKB.py:6-28).
    """
    pts = [np.asarray(p, dtype=float) for p in (p0, p1, p2, p3)]
    n = np.zeros(3)
    for i in range(4):
        j = (i + 1) % 4
        xi, yi, zi = pts[i]
        xj, yj, zj = pts[j]
        n[0] += (yi - yj) * (zi + zj)
        n[1] += (zi - zj) * (xi + xj)
        n[2] += (xi - xj) * (yi + yj)
    norm = np.linalg.norm(n)
    return n / norm if norm else np.full(3, np.nan)


@_on_host
def rotation_between(ref, tgt, eps: float = 1e-8) -> np.ndarray:
    """Rotation matrix mapping ``ref`` onto ``tgt`` (Rodrigues).

    Parity: ``rotation_matrix_from_vectors`` (surfacedetailAKB.py:36-71),
    including the antiparallel special case.
    """
    a = np.asarray(ref, float)
    b = np.asarray(tgt, float)
    a = a / np.linalg.norm(a)
    b = b / np.linalg.norm(b)
    v = np.cross(a, b)
    c = float(np.dot(a, b))
    s2 = float(np.dot(v, v))

    def skew(u):
        return np.array([[0, -u[2], u[1]], [u[2], 0, -u[0]], [-u[1], u[0], 0]])

    if s2 < eps:
        if c > 0:
            return np.eye(3)
        axis = np.cross(a, [1.0, 0, 0])
        if np.linalg.norm(axis) < eps:
            axis = np.cross(a, [0.0, 1, 0])
        axis /= np.linalg.norm(axis)
        K = skew(axis)
        return np.eye(3) + 2 * K @ K
    K = skew(v)
    return np.eye(3) + K + K @ K * ((1 - c) / s2)


@_on_host
def rotate_point_cloud(points, ref_vec, tgt_vec) -> np.ndarray:
    """Parity: ``rotate_point_cloud`` (surfacedetailAKB.py:74-82)."""
    return rotation_between(ref_vec, tgt_vec) @ np.asarray(points)


@_on_host
def sideview_profile(points, rot_angle=None):
    """Rotate a traced (3,N) cloud's (x,z) to a horizontal-chord profile.

    The reference pattern (AKB_raytrace_20250312.py:2722-2727 and
    surfacedetailAKB usage): rotate by -arctan(span_z/span_x) and zero the
    minima.
    """
    p = np.asarray(points)
    if rot_angle is None:
        rot_angle = np.arctan((np.max(p[2]) - np.min(p[2]))
                              / (np.max(p[0]) - np.min(p[0])))
    ax, sv = rotation_2d(p[0], p[2], -rot_angle)
    return ax - np.min(ax), sv - np.min(sv)


# --- profile cross-check (compareCSV.py) ---

@_on_host
def compare_profiles(x1, y1, x2, y2, dx: float = 0.1, align: str = "max"):
    """Residual between two profiles on a common grid, linearly detrended.

    Parity: compareCSV.py:17-64 — offsets each profile to (min x, max y),
    aligns by the peak position, interpolates to the overlap grid,
    subtracts, removes the best-fit line.
    Returns (x_common, y1_i, y2_i, residual).
    """
    x1 = np.asarray(x1, float) - np.min(x1)
    x2 = np.asarray(x2, float) - np.min(x2)
    y1 = np.asarray(y1, float) - np.max(y1)
    y2 = np.asarray(y2, float) - np.max(y2)
    if align == "max":
        x2 = x2 - (x2[np.argmax(y2)] - x1[np.argmax(y1)])
    x_min = max(x1.min(), x2.min())
    x_max = min(x1.max(), x2.max())
    xc = np.arange(x_min, x_max + dx, dx)
    y1_i = np.interp(xc, x1, y1)
    y2_i = np.interp(xc, x2, y2)
    diff = y1_i - y2_i
    coeffs = np.polyfit(xc, diff, 1)
    diff = diff - np.polyval(coeffs, xc)
    return xc, y1_i, y2_i, diff
