"""Pupil rectification (port of :mod:`akbx.analysis.rectify`): the
NaN-bounded parallelogram of a wavefront map -> a unit square.

Corner detection on the valid mask and the rotation estimate stay numpy
on the host, as in akbx (they pick indices, they carry no gradient); the
affine map is formed from three corners and sampled by a bilinear gather,
differentiable in the image values, on the image's device.
"""

from __future__ import annotations

import numpy as np
import torch

from akbx_torch.utils import linspace, to_numpy

F64 = torch.float64


def detect_corners(valid_mask: np.ndarray) -> np.ndarray:
    """Three anchor corners (top-left, top-right, bottom-left) of the valid
    region, as (x=col, y=row), ordered like the reference's
    ``order_points_affine``."""
    rr, cc = np.nonzero(np.asarray(valid_mask))
    pts = np.stack([cc, rr], axis=1).astype(np.float64)
    s = pts.sum(axis=1)
    d = np.diff(pts, axis=1).ravel()
    return np.stack([pts[np.argmin(s)], pts[np.argmin(d)], pts[np.argmax(d)]])


def bilinear_sample(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                    fill=float("nan")):
    """Bilinear sampling of ``img`` at (x=col, y=row); NaN pixels and
    pixels off the image carry no weight, and a sample with less than half
    its weight on valid pixels is ``fill``."""
    ny, nx = img.shape
    mask = torch.isfinite(img)
    filled = torch.where(mask, img, 0.0)
    x0f, y0f = torch.floor(x), torch.floor(y)
    x0, y0 = x0f.long(), y0f.long()
    wx, wy = x - x0f, y - y0f

    def at(yy, xx):
        ok = (yy >= 0) & (yy < ny) & (xx >= 0) & (xx < nx)
        yy = torch.clamp(yy, 0, ny - 1)
        xx = torch.clamp(xx, 0, nx - 1)
        m = mask[yy, xx] & ok
        return torch.where(m, filled[yy, xx], 0.0), m.to(img.dtype)

    v00, m00 = at(y0, x0)
    v01, m01 = at(y0, x0 + 1)
    v10, m10 = at(y0 + 1, x0)
    v11, m11 = at(y0 + 1, x0 + 1)
    w00 = (1 - wx) * (1 - wy)
    w01 = wx * (1 - wy)
    w10 = (1 - wx) * wy
    w11 = wx * wy
    num = v00 * w00 + v01 * w01 + v10 * w10 + v11 * w11
    den = m00 * w00 + m01 * w01 + m10 * w10 + m11 * w11
    out = num / torch.clamp_min(den, 1e-12)
    return torch.where(den > 0.5, out, fill)


def affine_rectify(img: torch.Tensor, corners, size: int) -> torch.Tensor:
    """Map the parallelogram spanned by (top-left, top-right, bottom-left)
    onto a (size, size) square by bilinear sampling: output pixel (0, 0)
    is the top-left corner, (0, size-1) top-right, (size-1, 0)
    bottom-left."""
    c = torch.as_tensor(np.asarray(corners), dtype=F64, device=img.device)
    u = linspace(0.0, 1.0, size, like=c)
    uu, vv = torch.meshgrid(u, u, indexing="xy")
    x = c[0, 0] + uu * (c[1, 0] - c[0, 0]) + vv * (c[2, 0] - c[0, 0])
    y = c[0, 1] + uu * (c[1, 1] - c[0, 1]) + vv * (c[2, 1] - c[0, 1])
    return bilinear_sample(img, x, y)


def extract_square_region(img, size: int | None = None) -> torch.Tensor:
    """Detect the corners from the NaN mask and rectify."""
    corners = detect_corners(np.isfinite(to_numpy(img)))
    if size is None:
        w = np.linalg.norm(corners[0] - corners[1])
        h = np.linalg.norm(corners[0] - corners[2])
        size = int(max(w, h))
    return affine_rectify(torch.as_tensor(img), corners, size)


def rotate_with_nan(data: torch.Tensor, angle_rad, order: int = 1
                    ) -> torch.Tensor:
    """Mask-normalized rotation about the image center by inverse-map
    bilinear sampling; ``angle_rad`` rotates the content counterclockwise
    (``scipy.ndimage.rotate``'s convention, which the reference uses)."""
    ny, nx = data.shape
    cy, cx = (ny - 1) / 2.0, (nx - 1) / 2.0
    yy, xx = torch.meshgrid(torch.arange(ny, dtype=F64, device=data.device),
                            torch.arange(nx, dtype=F64, device=data.device),
                            indexing="ij")
    a = torch.as_tensor(angle_rad, dtype=F64, device=data.device)
    ca, sa = torch.cos(a), torch.sin(a)
    xs = cx - (yy - cy) * sa + (xx - cx) * ca
    ys = cy + (yy - cy) * ca + (xx - cx) * sa
    return bilinear_sample(data, xs, ys)


def estimate_grid_rotation(wave_map) -> float:
    """Pupil-rotation estimate from the NaN envelope: the first valid row
    of each column, the slope between the 1/4 and 3/4 columns."""
    m = np.isfinite(to_numpy(wave_map))
    n_wid = m.shape[1]
    first = np.full(n_wid, np.nan)
    for i in range(n_wid):
        idx = np.nonzero(m[:, i])[0]
        if idx.size:
            first[i] = idx.min()
    i1, i2 = n_wid // 4, n_wid * 3 // 4
    return float(np.arctan((first[i1] - first[i2]) / (i1 - i2)))
