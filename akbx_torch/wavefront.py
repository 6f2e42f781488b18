"""Wavefront-map construction (port of :mod:`akbx.wavefront`): gridding
and plane correction.

* ``resample_quasigrid`` resamples values sampled on the engine's (nV, nH)
  quasi-grid of detector intersections (rows and columns monotone after
  the exit-pupil re-fan) onto a regular grid, as two passes of 1-D
  interpolation: every row at once, then every column at once.
* ``plane_correction`` is a quadratic pre-fit, a 3-sigma outlier mask and
  a linear plane re-fit, subtracted; masked least squares by f64 normal
  equations.

Everything is differentiable and runs on the device of its inputs.
"""

from __future__ import annotations

import torch

from akbx_torch.trace import interp
from akbx_torch.utils import linspace

_BIG = 1e300


def _interp_masked(x_new, x, y, valid):
    """Row-wise 1-D linear interpolation of (x, y) onto ``x_new`` (m,):
    ``x``, ``y``, ``valid`` are (B, n), each row increasing or decreasing
    in x.  Invalid samples are ignored; points outside a row's valid span
    come back flagged.  Returns ((B, m) values, (B, m) ok)."""
    sign = torch.where(x[:, -1:] >= x[:, :1], 1.0, -1.0).to(x.dtype)
    xs = sign * x
    xs_v = torch.where(valid, xs, _BIG)
    ys_v = torch.where(valid, y, 0.0)  # keep NaNs of masked samples out
    xs_sorted, order = torch.sort(xs_v, dim=1, stable=True)
    ys_sorted = torch.gather(ys_v, 1, order)
    xq = sign * x_new[None, :]
    yq = interp(xq, xs_sorted, ys_sorted)
    lo = torch.where(valid, xs, _BIG).amin(dim=1, keepdim=True)
    hi = torch.where(valid, xs, -_BIG).amax(dim=1, keepdim=True)
    n_valid = valid.sum(dim=1, keepdim=True)
    return yq, (xq >= lo) & (xq <= hi) & (n_valid >= 2)


def resample_quasigrid(y_pts, z_pts, values, valid, y_grid, z_grid):
    """Resample values sampled on a (nV, nH) quasi-grid onto a regular grid.

    ``y_pts``/``z_pts``/``values``/``valid`` are (nV, nH) (horizontal
    coordinate, vertical coordinate, sample value, mask); ``y_grid``
    (nH',), ``z_grid`` (nV',).  Returns (nV', nH') with NaN outside the
    pupil."""
    # pass 1: each row -> value and z on y_grid
    vals_r, ok1 = _interp_masked(y_grid, y_pts, values, valid)
    z_r, ok2 = _interp_masked(y_grid, y_pts, z_pts, valid)
    # pass 2: each column -> onto z_grid
    vals_c, ok_c = _interp_masked(z_grid, z_r.T, vals_r.T, (ok1 & ok2).T)
    return torch.where(ok_c, vals_c, float("nan")).T


def _design_matrix(yy, xx, order: int):
    cols = [torch.ones_like(yy)]
    if order >= 1:
        cols += [xx, yy]
    if order >= 2:
        cols += [xx * yy, xx**2, yy**2]
    return torch.stack(cols, dim=-1)


def _masked_lstsq(A, b, w):
    """Weighted least squares via normal equations (mask as weights)."""
    Aw = A * w[:, None]
    eye = torch.eye(A.shape[1], dtype=A.dtype, device=A.device)
    return torch.linalg.solve(Aw.T @ A + 1e-30 * eye, Aw.T @ b)


def plane_correction(img: torch.Tensor, sigma: float = 3.0) -> torch.Tensor:
    """Quadratic pre-fit -> sigma-clip -> linear plane re-fit -> subtract.
    NaN-preserving (the reference's
    ``plane_correction_with_nan_and_outlier_filter``)."""
    ny, nx = img.shape
    yy, xx = torch.meshgrid(
        torch.arange(ny, dtype=img.dtype, device=img.device),
        torch.arange(nx, dtype=img.dtype, device=img.device), indexing="ij")
    flat = img.reshape(-1)
    m = torch.isfinite(flat)
    w = m.to(img.dtype)
    b = torch.where(m, flat, 0.0)

    A2 = _design_matrix(yy.reshape(-1), xx.reshape(-1), 2)
    resid = b - A2 @ _masked_lstsq(A2, b, w)
    std = torch.sqrt(torch.sum(w * resid**2) / torch.clamp_min(torch.sum(w),
                                                                 1.0))
    keep = m & (torch.abs(resid) <= sigma * std)

    A1 = _design_matrix(yy.reshape(-1), xx.reshape(-1), 1)
    corrected = flat - A1 @ _masked_lstsq(A1, b, keep.to(img.dtype))
    return torch.where(m, corrected, float("nan")).reshape(ny, nx)


def _nanmean(x: torch.Tensor) -> torch.Tensor:
    """Mean over the finite entries (``jnp.nanmean`` on NaN-masked maps)."""
    m = torch.isfinite(x)
    return torch.sum(torch.where(m, x, 0.0)) / torch.sum(m)


def wavefront_grid(engine_result, n_h: int, n_v: int):
    """The gridded, plane-corrected wavefront map [nm] on the defocused
    detector plane.  Returns (matrix (nV, nH), grid_y (nH,), grid_z
    (nV,))."""
    det2 = engine_result.detcenter2
    y = det2[1].reshape(n_v, n_h)
    z = det2[2].reshape(n_v, n_h)
    w = engine_result.wave2.reshape(n_v, n_h)
    valid = engine_result.valid.reshape(n_v, n_h)

    inf = float("inf")
    y_grid = linspace(torch.where(valid, y, inf).amin(),
                      torch.where(valid, y, -inf).amax(), n_h)
    z_grid = linspace(torch.where(valid, z, inf).amin(),
                      torch.where(valid, z, -inf).amax(), n_v)

    mat = resample_quasigrid(y, z, w, valid, y_grid, z_grid)
    mat = plane_correction(mat - _nanmean(mat))
    return mat, y_grid, z_grid


def pv_6sigma(wave_map_lambda: torch.Tensor) -> torch.Tensor:
    """The reference's headline wavefront metric: 6 sigma (population std
    over the finite entries) of the map in wavelength units."""
    m = torch.isfinite(wave_map_lambda)
    dev = torch.where(m, wave_map_lambda - _nanmean(wave_map_lambda), 0.0)
    return torch.sqrt(torch.sum(dev * dev) / torch.sum(m)) * 6.0
