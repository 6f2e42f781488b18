"""Focus and alignment (port of :mod:`akbx.align`).

1. **Closed-form best focus.**  The spot std along a detector scan is a
   quadratic in the plane position, so the minimizing plane is a weighted
   least-squares crossing point: ``x* = x0 - cov(y, s) / var(s)`` with
   ``s = dy/dx`` the transverse ray slope.  One trace per iteration
   replaces the reference's shrink loops.
2. **Gradient-based alignment.**  The trace is differentiable, so the
   sensitivity matrix of an aberration vector is its Jacobian (reverse
   mode, one backward per metric row), the alignment solve a minimum-norm
   SVD least-squares step, and misalignment recovery Adam on a loss.

``shrink_search`` keeps the reference's derivative-free search.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from akbx_torch import trace as tr
from akbx_torch import wavefront
from akbx_torch.analysis import legendre, rectify
from akbx_torch.systems import AlignParams
from akbx_torch.utils import linspace, to_numpy

F64 = torch.float64


def best_focus_axis(points, rays, valid, axis: int):
    """Closed-form least-squares focal plane along x for one transverse axis.

    Minimizes std of ``c + (x - x0) * s`` over x, where c is the transverse
    coordinate at the reference plane and s the ray slope.  Returns
    (x_offset_from_points_plane, spot_std_at_focus).
    """
    w = valid.to(points.dtype)
    n = torch.clamp_min(torch.sum(w), 1.0)
    c = points[axis]
    s = rays[axis] / rays[0]
    cm = torch.sum(w * c) / n
    sm = torch.sum(w * s) / n
    cc = c - cm
    sc = s - sm
    cov = torch.sum(w * cc * sc) / n
    var = torch.clamp_min(torch.sum(w * sc * sc) / n, 1e-300)
    dx = -cov / var
    resid = cc + dx * sc
    std = torch.sqrt(torch.sum(w * resid**2) / n)
    return dx, std


def best_focus(result: "tr.TraceResult", x_ref):
    """Best focal-plane positions (absolute x) for H (y) and V (z)."""
    det = tr.detector_points(result, x_ref)
    dx_h, std_h = best_focus_axis(det, result.exit_rays, result.valid, 1)
    dx_v, std_v = best_focus_axis(det, result.exit_rays, result.valid, 2)
    return x_ref + dx_h, x_ref + dx_v, std_h, std_v


def auto_focus(build_fn: Callable[[AlignParams], object], params: AlignParams,
               n: int = 21, iters: int = 3, astig_gain: float = 0.5):
    """Adjust (defocus, astigH) so the H and V foci coincide on the detector.

    Each iteration is one f64 trace of an ``n`` x ``n`` fan plus the closed
    form focus; astigH follows a secant iteration on the focus gap, and
    defocus the midpoint of the two foci.  Returns updated AlignParams.
    """
    def measure(p):
        sys_ = build_fn(p)
        res = tr.run(sys_, n, n, defocus=p.defocus,
                     exit_pupil_uniform=False, tilt_correction=True)
        x_h, x_v, _, _ = best_focus(res.trace, sys_.s2f_middle + p.defocus)
        return x_h, x_v, sys_.s2f_middle

    p = params
    x_h, x_v, s2f = measure(p)
    gap_prev = x_h - x_v
    astig_prev = p.astig_h
    p = p._replace(defocus=(x_h + x_v) / 2 - s2f,
                   astig_h=p.astig_h - astig_gain * gap_prev)
    for _ in range(iters - 1):
        x_h, x_v, s2f = measure(p)
        gap = x_h - x_v
        slope = (gap - gap_prev) / (p.astig_h - astig_prev)
        slope = torch.where(torch.abs(slope) > 1e-6, slope, -1.0)
        astig_prev, gap_prev = p.astig_h, gap
        p = p._replace(defocus=(x_h + x_v) / 2 - s2f,
                       astig_h=p.astig_h - gap / slope)
    return p


def shrink_search(func: Callable, x_min: float, x_max: float,
                  num_steps: int = 100, shrink_factor: float = 0.1,
                  max_attempts: int = 20, tolerance: float = 1e-13):
    """Generic scalar shrink search (the reference's
    ``optimize_min_index``): sample ``func`` on a grid, shrink the range
    about the minimum, repeat.  A host loop; returns (best_x, min_y)."""
    best_x, min_y = None, None
    for _ in range(max_attempts):
        xs = linspace(x_min, x_max, num_steps)
        ys = torch.tensor([float(func(float(x))) for x in xs], dtype=F64)
        i = int(torch.argmin(ys))
        best_x, min_y = float(xs[i]), float(ys[i])
        delta = (x_max - x_min) * shrink_factor
        x_min, x_max = best_x - delta / 2, best_x + delta / 2
        if (x_max - x_min) < tolerance:
            break
    return best_x, min_y


class SepMetrics(NamedTuple):
    """Per-aperture-slice astigmatic focus signature (the reference's
    ``compare_sep`` 12-tuple): best-focus position and residual spot of
    the center column/row of the ray grid, the edge columns/rows, and the
    two diagonals."""

    focus_v0: torch.Tensor
    focus_h0: torch.Tensor
    pos_v0: torch.Tensor
    pos_h0: torch.Tensor
    std_v0: torch.Tensor
    std_h0: torch.Tensor
    focus_v_l: torch.Tensor
    focus_h_l: torch.Tensor
    focus_v_u: torch.Tensor
    focus_h_u: torch.Tensor
    focus_std_obl1: torch.Tensor
    focus_std_obl2: torch.Tensor

    def to_vector(self):
        return torch.stack(list(self))


def compare_sep(result: "tr.TraceResult", x_ref, n_h: int, n_v: int
                ) -> SepMetrics:
    """Aberration signature from independent closed-form focus searches
    on slices of the ray grid: columns (fixed H index) first / center /
    last, the same rows, and the two diagonals."""
    rays = result.exit_rays
    valid = result.valid
    idx = torch.arange(n_h * n_v, device=rays.device)
    det = tr.detector_points(result, x_ref)

    def slice_focus(sel_mask, axis):
        v = valid & sel_mask
        dx, std = best_focus_axis(det, rays, v, axis)
        # mean transverse position of the slice at its own focus
        w = v.to(det.dtype)
        n = torch.clamp_min(torch.sum(w), 1.0)
        pos = torch.sum(w * (det[axis] + dx * rays[axis] / rays[0])) / n
        return x_ref + dx, pos, std

    def col(i):
        return (idx % n_h) == i

    def row(j):
        return (idx // n_h) == j

    diag1 = (idx % n_h) == (idx // n_h)
    diag2 = (idx % n_h) == (n_v - 1 - idx // n_h)

    f_v0, pos_v0, s_v0 = slice_focus(col((n_h - 1) // 2), 2)
    f_h0, pos_h0, s_h0 = slice_focus(row((n_v - 1) // 2), 1)
    f_v_l, _, _ = slice_focus(col(0), 2)
    f_v_u, _, _ = slice_focus(col(n_h - 1), 2)
    f_h_l, _, _ = slice_focus(row(0), 1)
    f_h_u, _, _ = slice_focus(row(n_v - 1), 1)
    f_o1_v, _, _ = slice_focus(diag1, 2)
    f_o2_v, _, _ = slice_focus(diag2, 2)
    return SepMetrics(f_v0, f_h0, pos_v0, pos_h0, s_v0, s_h0,
                      f_v_l, f_h_l, f_v_u, f_h_u, f_o1_v, f_o2_v)


def aberration_vector(metrics: SepMetrics, mode: str = "abrr"
                      ) -> torch.Tensor:
    """The aberration components the sensitivity solve drives to zero."""
    m = metrics
    if mode == "KB":
        return torch.stack([m.focus_v0 - m.focus_h0,
                            m.focus_v_u - m.focus_v_l,
                            m.focus_h_u - m.focus_h_l])
    return torch.stack([
        m.focus_v0 - m.focus_h0,          # astigmatism
        m.focus_v_u - m.focus_v_l,        # V focal tilt across H aperture
        m.focus_h_u - m.focus_h_l,        # H focal tilt across V aperture
        m.focus_std_obl1 - m.focus_std_obl2,  # oblique astigmatism
        m.pos_v0,                         # pointing V
        m.pos_h0,                         # pointing H
    ])


def _value_and_jacobian(metric_fn, params_vec, param_indices):
    """(metrics, d metrics / d params[param_indices]) of one forward pass:
    reverse mode, one backward per metric row."""
    p = params_vec.detach().clone().requires_grad_(True)
    with torch.enable_grad():
        m = metric_fn(p)
        rows = [torch.autograd.grad(m[i], p, retain_graph=i + 1 < m.shape[0],
                                    allow_unused=True)[0]
                for i in range(m.shape[0])]
    J = torch.stack([torch.zeros_like(p) if r is None else r for r in rows])
    idx = torch.as_tensor(param_indices, device=p.device)
    return m.detach(), J[:, idx]


def sensitivity_matrix(metric_fn: Callable[[torch.Tensor], torch.Tensor],
                       params_vec: torch.Tensor, param_indices
                       ) -> torch.Tensor:
    """d(metrics)/d(params) of ``metric_fn`` (26-vector -> aberration
    vector) at ``params_vec``; (n_metrics, len(param_indices))."""
    return _value_and_jacobian(metric_fn, params_vec, param_indices)[1]


def solve_alignment(metric_fn, params_vec, param_indices, iters: int = 1,
                    damping: float = 1.0):
    """Newton-style alignment: measure the aberrations, solve the
    sensitivity system in least squares, apply the correction.  The solve
    is ``jnp.linalg.lstsq(rcond=None)``'s: an SVD minimum-norm solution
    with singular values below ``eps max(M, N)`` of the largest cut, so a
    rank-deficient matrix moves only the parameters it sees."""
    p = torch.as_tensor(params_vec, dtype=F64).detach().clone()
    idx = torch.as_tensor(param_indices, device=p.device)
    for _ in range(iters):
        m, J = _value_and_jacobian(metric_fn, p, idx)
        rtol = torch.finfo(J.dtype).eps * max(J.shape)
        delta = torch.linalg.pinv(J, rtol=rtol) @ -m
        p = p.index_add(0, idx, damping * delta)
    return p


def gradient_align(loss_fn: Callable[[torch.Tensor], torch.Tensor],
                   params_vec: torch.Tensor, free_indices, steps: int = 100,
                   lr: float = 1e-6):
    """Adam (beta 0.9 / 0.999, eps 1e-8, as optax's ``adam``) on a
    differentiable loss over the ``free_indices`` of the 26-vector.
    Returns (the vector with the free entries set, the loss of the last
    step)."""
    params_vec = torch.as_tensor(params_vec, dtype=F64).detach()
    idx = torch.as_tensor(free_indices, device=params_vec.device)
    x = params_vec[idx].clone().requires_grad_(True)
    opt = torch.optim.Adam([x], lr=lr, betas=(0.9, 0.999), eps=1e-8)
    v = None
    for _ in range(steps):
        opt.zero_grad()
        v = loss_fn(params_vec.index_put((idx,), x))
        v.backward()
        opt.step()
    return params_vec.index_put((idx,), x.detach()), v.detach()


def _legendre_signature(build_fn, p: AlignParams, n: int, assess_order: int,
                        wavelength_nm: float):
    """Trace, grid, rectify and decompose: (pvs, inner_products, orders,
    map)."""
    sys_ = build_fn(p)
    res = tr.run(sys_, n, n, defocus=p.defocus)
    mat, _, _ = wavefront.wavefront_grid(res, n, n)
    rect = rectify.extract_square_region(mat / wavelength_nm, n)
    fits, ips, orders = legendre.match_multi(rect[1:-2, 1:-2], assess_order)
    return to_numpy(legendre.mode_pvs(fits, ips)), ips, orders, mat


def legendre_alignment_sweep(build_fn, base_params: AlignParams,
                             param_index: int, values, n: int = 21,
                             assess_order: int = 5,
                             wavelength_nm: float = 13.5,
                             autofocus: bool = True):
    """Sweep one alignment parameter and fit each Legendre mode's response
    (the reference's ``Legendrealignment``): for each value, (optionally)
    autofocus, trace, decompose, then fit inner products and PVs linearly
    against the parameter.  Returns a dict of 'values', 'inner_products'
    (runs, modes), 'pvs' (runs, modes+1), 'orders', 'ip_slopes',
    'pv_slopes'."""
    base = base_params.to_vector()
    ips_runs, pvs_runs = [], []
    orders = None
    for value in values:
        vec = base.clone()
        vec[param_index] = float(value)
        p = AlignParams.from_vector(vec)
        if autofocus:
            p = auto_focus(build_fn, p, n=n, iters=3)
        pvs, ips, orders, mat = _legendre_signature(build_fn, p, n,
                                                    assess_order,
                                                    wavelength_nm)
        pv6 = float(wavefront.pv_6sigma(mat / wavelength_nm))
        ips_runs.append(to_numpy(ips))
        pvs_runs.append(np.append(pvs, pv6))
    ips_runs = np.array(ips_runs)
    pvs_runs = np.array(pvs_runs)
    values = np.asarray(values, dtype=float)
    ip_slopes = np.array([np.polyfit(values, ips_runs[:, i], 1)
                          for i in range(ips_runs.shape[1])])
    pv_slopes = np.array([np.polyfit(values, pvs_runs[:, i], 1)
                          for i in range(pvs_runs.shape[1])])
    return {"values": values, "inner_products": ips_runs, "pvs": pvs_runs,
            "orders": orders, "ip_slopes": ip_slopes, "pv_slopes": pv_slopes}


def fine_tune(build_fn, params: AlignParams, n: int = 21,
              assess_order: int = 5, wavelength_nm: float = 13.5,
              span_defocus: float = 2e-5, span_astig: float = 2e-5,
              samples: int = 3):
    """Zero the astigmatism and defocus Legendre signatures by linear fit
    (the reference's ``Finetuning``): sweep astigH, then defocus, over a
    small span, fit ``pv(0,2) - pv(2,0)`` and ``pv(0,2) + pv(2,0)``
    linearly and move to the fitted zero crossings.  Returns updated
    AlignParams."""
    dev = params.defocus.device

    def signature(p):
        pv, _, orders, _ = _legendre_signature(build_fn, p, n, assess_order,
                                               wavelength_nm)
        i20, i02 = orders.index((2, 0)), orders.index((0, 2))
        return pv[i02] - pv[i20], pv[i02] + pv[i20]

    def zero_crossing(field, channel, span):
        x0 = float(getattr(params, field))
        xs = x0 + np.linspace(-span, span, samples)
        sig = [signature(params._replace(**{field: torch.tensor(
            x, dtype=F64, device=dev)}))[channel] for x in xs]
        slope, icpt = np.polyfit(xs, sig, 1)
        new = -icpt / slope if abs(slope) > 1e-30 else x0
        return params._replace(**{field: torch.tensor(new, dtype=F64,
                                                      device=dev)})

    params = zero_crossing("astig_h", 0, span_astig)
    return zero_crossing("defocus", 1, span_defocus)


def field_of_curvature(build_fn, params: AlignParams, shifts_y, shifts_z,
                       n: int = 17):
    """Field-of-curvature map: best focus for a grid of source shifts (the
    reference's ``calc_FoC``).  Returns a dict of (len(shifts_z),
    len(shifts_y)) arrays: focus_x_h/v, spot_h/v."""
    out = {k: np.zeros((len(shifts_z), len(shifts_y)))
           for k in ("focus_x_h", "focus_x_v", "spot_h", "spot_v")}
    for iz, sz in enumerate(shifts_z):
        for iy, sy in enumerate(shifts_y):
            sys_ = build_fn(params, source_shift=(0.0, sy, sz))
            res = tr.run(sys_, n, n, defocus=params.defocus,
                         exit_pupil_uniform=False)
            found = best_focus(res.trace, sys_.s2f_middle + params.defocus)
            for k, v in zip(out, found):
                out[k][iz, iy] = float(v)
    return out
