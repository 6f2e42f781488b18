"""Fraunhofer / Fresnel PSF computation (port of
:mod:`akbx.analysis.psf`).

Phases are built in f64 and wrapped mod 2 pi (floor-mod, as
``jnp.mod``); the field and its FFT are complex128 everywhere, on the
card as on the CPU (cuFFT's Z2Z there).  The direct Fresnel sum loops
over chunks of pupil samples.  Everything is differentiable.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from akbx_torch.analysis import rectify
from akbx_torch.utils import to_numpy

F64 = torch.float64


def ensure_even_size(arr: torch.Tensor) -> torch.Tensor:
    """Pad odd side lengths by one zero pixel (bottom, right)."""
    ny, nx = arr.shape
    if ny % 2 == 0 and nx % 2 == 0:
        return arr
    out = arr.new_zeros((ny + ny % 2, nx + nx % 2))
    out[:ny, :nx] = arr
    return out


def hann2d(shape, device=None) -> torch.Tensor:
    """Separable 2D Hann window, unit peak."""
    ny, nx = shape

    def hann(n):
        k = torch.arange(n, dtype=F64, device=device)
        return 0.5 - 0.5 * torch.cos(2 * math.pi * k / n)

    w = torch.outer(hann(ny), hann(nx))
    return w / torch.max(w)


def _fftfreq(n: int, d: float, device=None) -> torch.Tensor:
    """``jnp.fft.fftfreq``: [0, 1, ..., -n/2, ..., -1] / (d n), divided
    (``torch.fft.fftfreq`` multiplies by the reciprocal)."""
    k = torch.cat([torch.arange(0, (n + 1) // 2, dtype=F64, device=device),
                   torch.arange(-(n // 2), 0, dtype=F64, device=device)])
    return k / (d * n)


def compute_psf_fft(opd_m, amp, wavelength_m, pupil_dx_m, focal_length_m,
                    pad_factor: int = 2, window: str | None = None,
                    return_efield: bool = False, pupil_dy_m=None,
                    fft2_shifted_fn=None):
    """Fraunhofer PSF from a pupil OPD + amplitude by FFT: NaN masking,
    optional Hann window, even-size pad, centred zero-pad by
    ``pad_factor``, ``fftshift(fft2(ifftshift(U))) * dA``, image
    coordinates ``lambda f fftfreq``, peak normalization.
    ``fft2_shifted_fn`` replaces the ``fftshift(fft2(ifftshift(.)))``
    transform (:func:`akbx_torch.parallel.fft.psf_fft_sharded` shards it
    over a mesh).  Returns (psf, x_im, y_im[, efield])."""
    opd = torch.as_tensor(opd_m, dtype=F64)
    A = torch.as_tensor(amp, dtype=F64, device=opd.device)
    A = torch.where(torch.isfinite(A), A, 0.0)
    opd = torch.where(torch.isfinite(opd), opd, 0.0)

    phase = (2.0 * math.pi / wavelength_m) * opd
    phase = torch.remainder(phase + math.pi, 2 * math.pi) - math.pi
    U = torch.polar(A, phase)

    if window is not None:
        if str(window).lower() != "hann":
            raise ValueError(f"Unsupported window '{window}'")
        U = U * hann2d(U.shape, opd.device)

    U = ensure_even_size(U)
    ny, nx = U.shape
    py, px = ny * pad_factor, nx * pad_factor
    pad_y0, pad_x0 = (py - ny) // 2, (px - nx) // 2
    big = U.new_zeros((py, px))
    big[pad_y0:pad_y0 + ny, pad_x0:pad_x0 + nx] = U

    dx = pupil_dx_m
    dy = dx if pupil_dy_m is None else pupil_dy_m
    if fft2_shifted_fn is None:
        U_im = torch.fft.fftshift(torch.fft.fft2(torch.fft.ifftshift(big)))
    else:
        U_im = fft2_shifted_fn(big)
    U_im = U_im * (dx * dy)

    x_im = wavelength_m * focal_length_m * torch.fft.fftshift(
        _fftfreq(px, dx, opd.device))
    y_im = wavelength_m * focal_length_m * torch.fft.fftshift(
        _fftfreq(py, dy, opd.device))

    intensity = torch.abs(U_im) ** 2
    peak = torch.max(intensity)
    intensity = torch.where(peak > 0, intensity / peak, intensity)
    if return_efield:
        scale = torch.sqrt(torch.where(peak > 0, peak, 1.0))
        return intensity, x_im, y_im, U_im / scale
    return intensity, x_im, y_im


def psf_to_db(psf, floor_db: float = -60.0):
    return 10.0 * torch.log10(torch.clamp_min(psf, 10.0 ** (floor_db / 10.0)))


def fresnel_integral(phi, grid_x, grid_y, lambda_, z, x_out, y_out,
                     chunk: int = 4096):
    """Direct (non-FFT) Fresnel propagation of a masked pupil: the
    O(N_in N_out) sum in chunks of ``chunk`` pupil samples; NaN pupil
    samples carry zero weight.  Returns (psf normalized, x_out, y_out)."""
    k = 2 * math.pi / lambda_
    mask = torch.isfinite(phi).reshape(-1)
    w = mask.to(F64)
    phiv = torch.where(mask, phi.reshape(-1), 0.0)
    xin = torch.where(mask, grid_x.reshape(-1), 0.0)
    yin = torch.where(mask, grid_y.reshape(-1), 0.0)
    u_in_phase = k * phiv - k / (2 * z) * (xin**2 + yin**2)

    X, Y = torch.meshgrid(x_out, y_out, indexing="xy")
    Xf, Yf = X.reshape(-1), Y.reshape(-1)
    re = torch.zeros_like(Xf)
    im = torch.zeros_like(Xf)
    for i in range(0, xin.shape[0], chunk):
        s = slice(i, i + chunk)
        r = torch.sqrt((Xf[:, None] - xin[None, s]) ** 2
                       + (Yf[:, None] - yin[None, s]) ** 2 + z**2)
        ph = u_in_phase[None, s] - k * r
        amp = w[None, s] / r
        re = re + torch.sum(amp * torch.cos(ph), dim=1)
        im = im + torch.sum(amp * torch.sin(ph), dim=1)
    psf = (re**2 + im**2).reshape(X.shape)
    return psf / torch.max(psf), x_out, y_out


def fwhm(x, intensity_1d):
    """Half-max width by counting samples over half max."""
    dx = torch.abs(x[1] - x[0])
    n_over = torch.sum(intensity_1d >= 0.5 * torch.max(intensity_1d))
    return (n_over - 1) * dx


def strehl(psf_aberrated_peak_unnormalized, psf_ideal_peak_unnormalized):
    """Strehl ratio from unnormalized peak intensities."""
    return psf_aberrated_peak_unnormalized / psf_ideal_peak_unnormalized


def wavefront_error_v2(defocus_positions, path_lengths, angles,
                       focal_positions, wavelength):
    """OPD error + focal-plane position error + angle-error correction.
    Returns (wavefront_error (N,), rms)."""
    opd_error = path_lengths - torch.mean(path_lengths)
    focal_err = torch.linalg.vector_norm(
        focal_positions - torch.mean(focal_positions, dim=1, keepdim=True),
        dim=0)
    norms = torch.linalg.vector_norm(defocus_positions, dim=0, keepdim=True)
    dots = torch.sum(angles * (-defocus_positions / norms), dim=0)
    angle_corr = wavelength * (1.0 - dots) / (2 * math.pi)
    err = opd_error + focal_err + angle_corr
    return err, torch.sqrt(torch.mean(err**2))


def psf_from_wavefront(wave_map_nm, grid_y, grid_z, focal_length_m,
                       wavelength_m, pad_factor: int = 16,
                       derotate: bool = True):
    """The PSF of a gridded wavefront map [nm]: the pupil-grid rotation
    from the NaN envelope, mask-normalized derotation, amplitude = finite
    mask, padded Fraunhofer FFT (the reference's ``psf_calc`` without its
    plots and files).  Returns dict with psf, x_im, y_im, rotation_rad,
    wave_map_used."""
    wave_map_nm = torch.as_tensor(wave_map_nm)
    rot = 0.0
    if derotate:
        try:
            rot = rectify.estimate_grid_rotation(wave_map_nm)
        except (ValueError, IndexError):
            rot = 0.0
        if np.isfinite(rot) and abs(rot) > 0:
            wave_map_nm = rectify.rotate_with_nan(wave_map_nm, rot, order=1)

    finite = torch.isfinite(wave_map_nm)
    amp = finite.to(F64)
    opd = torch.where(finite, wave_map_nm * 1e-9, 0.0)
    dy = float(to_numpy(torch.abs(grid_y[1] - grid_y[0])))
    dz = float(to_numpy(torch.abs(grid_z[1] - grid_z[0])))
    psf_img, x_im, y_im = compute_psf_fft(opd, amp, wavelength_m, dy,
                                          focal_length_m,
                                          pad_factor=pad_factor,
                                          pupil_dy_m=dz)
    return {"psf": psf_img, "x_im": x_im, "y_im": y_im,
            "rotation_rad": float(rot), "wave_map_used": wave_map_nm}


def trim_window(psf_img, x_im, y_im, half_width_m: float):
    """Trim the PSF to +-half_width (host numpy)."""
    x, y = to_numpy(x_im), to_numpy(y_im)
    ix = np.where((x >= -half_width_m) & (x <= half_width_m))[0]
    iy = np.where((y >= -half_width_m) & (y <= half_width_m))[0]
    return to_numpy(psf_img)[np.ix_(iy, ix)], x[ix], y[iy]
