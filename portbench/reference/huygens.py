"""The plain Huygens sum of the reference and the wave handoff's
geometry: a frozen copy of the f64 path of ``akbx_torch/wave.py``
(``_huygens_chunk``, ``_propagate_xla``: the geometry re-centred on the
stage's centroid, k r in double-word and reduced mod 2 pi before the
sine and cosine), of ``akbx_torch/core/trig.py``'s ``sincos_reduced``,
of ``wave.calc_ds`` and of ``export.detector_grid``.  In float32 (the
control) the phase is the plain product k r.  Plain PyTorch; imports
nothing of the program.

    u[i] = sum_j u_src[j] * ds[j] * exp(-i k r_ij) / r_ij
"""

from __future__ import annotations

import math

import torch

from portbench.reference import precision as pr

F64 = torch.float64
TWO_PI_HI = 6.283185307179586
TWO_PI_LO = 2.4492935982947064e-16  # 2*pi = HI + LO to ~1e-32


def sincos_reduced(phase_hi, phase_lo):
    """sin and cos of a double-word phase, reduced mod 2 pi in
    double-word arithmetic."""
    n = torch.round(phase_hi / TWO_PI_HI)
    t1 = pr.two_prod(n, torch.full_like(n, TWO_PI_HI))
    red = pr.df_add(pr.DF(phase_hi, phase_lo), pr.DF(-t1.hi, -t1.lo))
    red = pr.df_add_f(red, -n * TWO_PI_LO)
    r = red.hi + red.lo
    return torch.sin(r), torch.cos(r)


def huygens(src_points, src_re, src_im, src_ds, targets, wavelength: float,
            dtype=F64, block: int = 256):
    """The field (re, im) at ``targets`` (3, N) from sources (3, M) with
    weights ``ds``, computed in ``dtype`` in blocks of ``block`` targets;
    returned in f64."""
    k = 2.0 * math.pi / wavelength
    center = torch.cat([src_points, targets], dim=1).mean(dim=1,
                                                          keepdim=True)
    src = (src_points - center).to(dtype)
    tgt = (targets - center).to(dtype)
    w_re = (src_re * src_ds).to(dtype)
    w_im = (src_im * src_ds).to(dtype)
    out_re, out_im = [], []
    for a in range(0, tgt.shape[1], block):
        t = tgt[:, a:a + block]
        dx = t[0][:, None] - src[0][None, :]
        dy = t[1][:, None] - src[1][None, :]
        dz = t[2][:, None] - src[2][None, :]
        r = torch.sqrt(dx * dx + dy * dy + dz * dz)
        if dtype == F64:
            kp = pr.two_prod(torch.full_like(r, k), r)
            s, c = sincos_reduced(-kp.hi, -kp.lo)
        else:
            phase = -(k * r)
            s, c = torch.sin(phase), torch.cos(phase)
        cr, sr = c / r, s / r
        out_re.append(cr @ w_re - sr @ w_im)
        out_im.append(sr @ w_re + cr @ w_im)
    return torch.cat(out_re).double(), torch.cat(out_im).double()


def calc_ds(points: torch.Tensor, n_v: int, n_h: int) -> torch.Tensor:
    """Per-point surface area from the 4 neighbour triangles, the edges
    copied inward: the Huygens quadrature weight."""
    g = points.reshape(3, n_v, n_h)

    def tri_area(p0, p1, p2):
        e1 = p1 - p0
        e2 = p2 - p0
        cx = e1[1] * e2[2] - e1[2] * e2[1]
        cy = e1[2] * e2[0] - e1[0] * e2[2]
        cz = e1[0] * e2[1] - e1[1] * e2[0]
        return torch.sqrt(cx**2 + cy**2 + cz**2) / 2

    p = g[:, 1:-1, 1:-1]
    right = g[:, 1:-1, 2:]
    left = g[:, 1:-1, :-2]
    up = g[:, :-2, 1:-1]
    down = g[:, 2:, 1:-1]
    inner = (tri_area(p, right, up) + tri_area(p, up, left)
             + tri_area(p, left, down) + tri_area(p, down, right))
    dS = torch.zeros((n_v, n_h), dtype=points.dtype, device=points.device)
    dS[1:-1, 1:-1] = inner
    dS[0, :] = dS[1, :]
    dS[-1, :] = dS[-2, :]
    dS[:, 0] = dS[:, 1]
    dS[:, -1] = dS[:, -2]
    dS[0, 0] = dS[1, 1]
    dS[0, -1] = dS[1, -2]
    dS[-1, 0] = dS[-2, 1]
    dS[-1, -1] = dS[-2, -2]
    return dS.reshape(-1)


def detector_grid(detcenter, valid, n: int, half_size: float):
    """A regular n x n grid (3, n*n) on the detector plane, centred on the
    spot of the valid rays, of half-size ``half_size`` in y and z."""
    det = detcenter[:, valid]
    yc = (det[1].min() + det[1].max()) / 2
    zc = (det[2].min() + det[2].max()) / 2
    s = torch.linspace(-half_size, half_size, n, dtype=F64,
                       device=det.device)
    zz, yy = torch.meshgrid(zc + s, yc + s, indexing="ij")
    xx = torch.full_like(yy, float(det[0].mean()))
    return torch.stack([xx.reshape(-1), yy.reshape(-1), zz.reshape(-1)])
