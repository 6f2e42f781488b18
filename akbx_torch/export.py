"""Ray -> wave handoff (port of :mod:`akbx.export`).

From one engine run: rotate every traced surface grid (and the source)
about the approximate focus so the exit beam axis is +x, build regular
detector grids around the focal and the defocused spot (the defocused
grid's half-size follows the reference's rule ``2e-7 + defocusForWave *
NA * 2``), optionally power-of-2 downsample each surface, and write the
reference-compatible file set through :mod:`akbx_torch.io`.
"""

from __future__ import annotations

import numpy as np
import torch

from akbx_torch import io, trace as tr, utils
from akbx_torch.core import geometry as geo
from akbx_torch.utils import to_numpy


def rotate_all_surfaces(result: "tr.TraceResult", engine: "tr.EngineResult"):
    """Rotate every surface grid + the source to the beam-axis frame.

    The engine's tilt correction already rotated the exit surface; this
    applies the same rotation to the remaining surfaces.
    """
    ty, tz, focus = engine.theta_y, engine.theta_z, engine.focus_apprx
    rotated = []
    for i, pts in enumerate(result.points):
        if i == len(result.points) - 1:
            rotated.append(pts)  # already rotated by tilt correction
        else:
            rotated.append(geo.rotate_points_about(pts, focus, -ty, -tz))
    source = geo.rotate_points_about(
        torch.zeros((3, 1), dtype=focus.dtype, device=focus.device), focus,
        -ty, -tz)
    return rotated, source


def detector_grid(detcenter, n_h: int, n_v: int, half_size_y: float,
                  half_size_z: float, valid=None):
    """Regular detector-plane grid centered on the spot, (3, n_v*n_h)
    numpy f64."""
    det = to_numpy(detcenter)
    if valid is not None:
        det = det[:, to_numpy(valid)]
    y = det[1]
    z = det[2]
    yc = (y.min() + y.max()) / 2
    zc = (z.min() + z.max()) / 2
    y_grid = np.linspace(yc - half_size_y, yc + half_size_y, n_h)
    z_grid = np.linspace(zc - half_size_z, zc + half_size_z, n_v)
    yy, zz = np.meshgrid(y_grid, z_grid)
    xx = np.full_like(yy, det[0].mean())
    return np.stack([xx.ravel(), yy.ravel(), zz.ravel()])


def defocus_grid_half_size(defocus_for_wave: float, na: float = 0.082,
                           base: float = 2e-7) -> float:
    """The reference's defocused-grid half-size rule."""
    return base + defocus_for_wave * na * 2


def wave_handoff(directory: str, system, engine: "tr.EngineResult",
                 n_h: int, n_v: int, *, image_half_size: float = 1e-6,
                 defocus_for_wave: float = 1e-3, na: float = 0.082,
                 downsample=(0, 0), image_pixels: int | None = None,
                 conditions_extra: dict | None = None) -> str:
    """Export the full wave-handoff directory from one engine run.

    ``downsample``: (down_h, down_v) power-of-2 decimation of the surface
    grids.  ``image_pixels`` defaults to the (possibly downsampled) grid
    size.  Returns the directory path.
    """
    result = engine.trace
    rotated, source = rotate_all_surfaces(result, engine)

    size_v, size_h = n_v, n_h
    surfaces = {}
    for i, pts in enumerate(rotated):
        arr, size_v, size_h = utils.downsample_grid(pts, n_v, n_h,
                                                    *downsample)
        surfaces[f"M{i+1}"] = (arr, size_v, size_h)

    npix = image_pixels or size_h
    grid_image = detector_grid(engine.detcenter, npix, npix,
                               image_half_size, image_half_size,
                               valid=engine.valid)
    half2 = defocus_grid_half_size(defocus_for_wave, na)
    grid_defocus = detector_grid(engine.detcenter2, npix, npix, half2, half2,
                                 valid=engine.valid)

    gi = grid_image.reshape(3, npix, npix)
    cond = {
        "grid pitch_y": gi[1, 0, 1] - gi[1, 0, 0],
        "grid pitch_z": gi[2, 1, 0] - gi[2, 0, 0],
        "grid size_y": gi[1].max() - gi[1].min(),
        "grid size_z": gi[2].max() - gi[2].min(),
        "grid pix_y": npix,
        "grid pix_z": npix,
        "grid pix_H1": size_h,
        "grid pix_V1": size_v,
        "grid pix_H2": size_h,
        "grid pix_V2": size_v,
        "option_AKB": len(rotated) == 4,
        "option_HighNA": True,
        "defocusForWave": defocus_for_wave,
        "calc both mirrors?": True,
        "option_avrgsplt": False,
    }
    cond.update(conditions_extra or {})
    return io.save_wave_data(directory, source[:, 0], surfaces,
                             grid_image, grid_defocus, conditions=cond)


def around_focus_spots(result: "tr.TraceResult", x_focus, offsets,
                       valid=None):
    """Spot metrics on a train of detector planes ``x_focus + offsets``
    around focus (the III_I engine's around-focus montage, as data).
    Returns a list of dicts with x, std_y, std_z, centroid (numpy)."""
    out = []
    v = result.valid if valid is None else valid
    for dx in np.asarray(offsets):
        det = tr.detector_points(result, x_focus + float(dx))
        sy, sz = tr.spot_size(det, v)
        c = tr.masked_mean(det, v[None, :], dim=1)
        out.append({"x": float(x_focus + dx), "std_y": float(sy),
                    "std_z": float(sz), "centroid": to_numpy(c)})
    return out
