"""The Huygens contraction K3 (port of :mod:`akbx.kernels.huygens`).

For every target point i,

    u[i] = sum_j (re_j + i im_j) ds_j exp(-i k r_ij) / r_ij ,

in double-f32 ("df32") arithmetic: the host re-centres both point clouds
on their joint centroid (so coordinates are O(1)) and splits them into
exact (hi, lo) f32 pairs; per pair, the distance and the phase ``k r`` are
df32, the phase is reduced mod 2pi in two df32 steps, and sin / cos are
f32.  Three parts: the plain PyTorch twin :func:`huygens_reference`, the
CUDA C++ kernel ``akbx_torch/csrc/huygens_kernel.cu``, and the
dispatching wrapper :func:`huygens`, which runs the twin on a CPU tensor
and launches the kernel on a CUDA tensor, never falling back.  It counts
its launches in ``huygens.launches``.

Twin and kernel compute the same f32 terms per pair with the same
operations in the same order (``two_prod`` is the FMA form in both, see
:mod:`akbx_torch.core.precision`).  As the TPU kernel does, each sums a
tile of :data:`TILE` sources in f32 and adds the tile sums, in tile order,
into an f32 total, cast to f64 at the end.  They differ only in the order
of the f32 sum inside a tile: the kernel adds the terms one by one in
source order, the twin with ``torch.sum``.

The wavenumber pair ``k_pair`` is a (2,) f32 tensor on the host whatever
device the rows are on: the kernel takes it by value.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from akbx_torch.core import use_kernel
from akbx_torch.core.precision import (DF, df_add, df_mul, df_neg,
                                       df_sqrt, df_sub, two_prod)
from akbx_torch.kernels import (F32, F64, check, ptr, raise_on, split64,
                                stream)

TWO_PI = 6.283185307179586
TWO_PI_HI32 = np.float32(6.2831855)
TWO_PI_LO32 = np.float32(TWO_PI - float(np.float32(6.2831855)))
TILE = 256          # sources per f32 partial sum (the kernel's H_TILE)
TWIN_PAIRS = 1 << 22  # the twin's (target chunk x sources) per pass


def _reduce_2pi(p: DF, hi: torch.Tensor, lo: torch.Tensor) -> DF:
    """One step of the mod-2pi reduction of a df32 phase."""
    n = torch.round(p.hi / hi)
    m = two_prod(n, hi)
    p = df_add(p, df_neg(m))
    nl = -n * lo
    return df_add(p, DF(nl, torch.zeros_like(nl)))


def pair_terms(t, s, sre, sim, k: DF):
    """The f32 terms ``(cr sre - sr sim, sr sre + cr sim)`` of every
    (target, source) pair: ``t``/``s`` are 3 DF coordinates broadcasting
    to the pair shape, ``sre``/``sim`` the source weights.  The op
    sequence of ``akbx/kernels/huygens.py:177-214`` and of the kernel."""
    d = [df_sub(t[r], s[r]) for r in range(3)]
    d2 = df_add(df_add(df_mul(d[0], d[0]), df_mul(d[1], d[1])),
                df_mul(d[2], d[2]))
    r = df_sqrt(d2)
    hi = torch.tensor(TWO_PI_HI32, device=r.hi.device)
    lo = torch.tensor(TWO_PI_LO32, device=r.hi.device)
    p = _reduce_2pi(_reduce_2pi(df_neg(df_mul(r, k)), hi, lo), hi, lo)
    phase = p.hi + p.lo
    sn, cs = torch.sin(phase), torch.cos(phase)
    inv_r = torch.where(r.hi > 1e-12, 1.0 / r.hi, 0.0)
    cr = cs * inv_r
    sr = sn * inv_r
    return cr * sre - sr * sim, sr * sre + cr * sim


def huygens_reference(tgt, src, w, k_pair, chunk: int | None = None):
    """Plain PyTorch twin of K3.

    ``tgt``: (6, N) f32 rows x_hi, x_lo, y_hi, y_lo, z_hi, z_lo of the
    re-centred targets; ``src``: (6, M) the same for the sources; ``w``:
    (2, M) f32 weights re ds, im ds; ``k_pair``: (2,) f32 (hi, lo) of the
    wavenumber, on the host.  Returns (re, im), each (N,) f64.  Runs over
    the source tiles and, inside each, over chunks of ``chunk`` targets
    (default: :data:`TWIN_PAIRS` pairs per chunk), so each live (chunk,
    TILE) array stays at chunk x TILE x 4 bytes.
    """
    n, m = tgt.shape[1], src.shape[1]
    out = torch.zeros((2, n), dtype=F32, device=tgt.device)
    if chunk is None:
        chunk = max(1, TWIN_PAIRS // TILE)
    k = DF(k_pair[0], k_pair[1])
    for b in range(0, m, TILE):
        s = [DF(src[2 * r, None, b:b + TILE], src[2 * r + 1, None, b:b + TILE])
             for r in range(3)]
        for a in range(0, n, chunk):
            t = [DF(tgt[2 * r, a:a + chunk, None],
                    tgt[2 * r + 1, a:a + chunk, None]) for r in range(3)]
            re, im = pair_terms(t, s, w[0, None, b:b + TILE],
                                w[1, None, b:b + TILE], k)
            out[0, a:a + chunk] += re.sum(dim=-1)
            out[1, a:a + chunk] += im.sum(dim=-1)
    return out[0].to(F64), out[1].to(F64)


def huygens(tgt, src, w, k_pair, chunk: int | None = None):
    """K3: the twin on a CPU tensor (``chunk`` is the twin's), the CUDA
    kernel on a CUDA tensor; contract of :func:`huygens_reference`."""
    if k_pair.device.type != "cpu":
        raise ValueError(f"k_pair on {k_pair.device}: the kernel takes the "
                         "wavenumber by value, keep it on the host")
    if not use_kernel(tgt, src, w):
        return huygens_reference(tgt, src, w, k_pair, chunk=chunk)
    from akbx_torch.kernels import _build

    n, m = tgt.shape[1], src.shape[1]
    check(tgt, F32, (6, n), "tgt")
    check(src, F32, (6, m), "src")
    check(w, F32, (2, m), "w")
    check(k_pair, F32, (2,), "k_pair")
    lib = _build.load()
    out = torch.empty((2, n), dtype=F32, device=tgt.device)
    if n:
        k_hi, k_lo = k_pair.tolist()
        rc = lib.akbx_huygens(ptr(tgt), n, ptr(src), ptr(w), m, k_hi, k_lo,
                              ptr(out), stream(tgt))
        raise_on(rc, "huygens")
        huygens.launches += 1
    return out[0].to(F64), out[1].to(F64)


huygens.launches = 0


def _split_rows(pts64: torch.Tensor) -> torch.Tensor:
    """(3, N) f64 -> (6, N) f32 rows x_hi, x_lo, y_hi, y_lo, z_hi, z_lo."""
    hi, lo = split64(pts64)
    return torch.stack([hi, lo], dim=1).reshape(6, -1).contiguous()


def _rows(tgt_pts, src_pts, src_re_w, src_im_w):
    """K3's rows from the re-centred f64 geometry and the f64 weights:
    df32 coordinate rows and f32 weight rows."""
    return (_split_rows(tgt_pts), _split_rows(src_pts),
            torch.stack([src_re_w, src_im_w]).to(F32))


def _huygens_pallas(tgt_pts, src_pts, src_re_w, src_im_w, k_pair,
                    chunk: int | None = None):
    """K3 (:func:`huygens`) on re-centred f64 geometry and f64 weights."""
    return huygens(*_rows(tgt_pts, src_pts, src_re_w, src_im_w), k_pair,
                   chunk=chunk)


def kernel_args(source, target_points, wavelength: float):
    """K3's arguments ``(tgt, src, w, k_pair)`` for the propagation of a
    :class:`akbx_torch.wave.WaveField` to ``target_points`` (3, N) f64.

    On the host, in f64: re-centre both clouds on their joint centroid,
    weight the field by ``ds``, and split ``k`` into an f32 (hi, lo)
    pair, which stays on the host.
    """
    k = 2.0 * math.pi / wavelength
    center = torch.cat([source.points, target_points], dim=1).mean(
        dim=1, keepdim=True)
    k_hi = np.float32(k)
    k_lo = np.float32(k - float(k_hi))
    return (*_rows(target_points - center, source.points - center,
                   source.re * source.ds, source.im * source.ds),
            torch.tensor(np.array([k_hi, k_lo])))


def propagate_pallas(source, target_points, wavelength: float,
                     chunk: int | None = None):
    """df32 Huygens propagation of a :class:`akbx_torch.wave.WaveField`
    to ``target_points`` (3, N) f64 through K3; returns (re, im) f64.
    ``chunk`` sets the twin's target chunk on CPU tensors."""
    return huygens(*kernel_args(source, target_points, wavelength),
                   chunk=chunk)
