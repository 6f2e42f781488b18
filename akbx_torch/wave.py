"""Huygens-Fresnel wave-optical propagation (port of :mod:`akbx.wave`).

Per stage, the O(N_target * N_source) sum

    u[i] = sum_j u_src[j] * ds[j] * exp(-i k r_ij) / r_ij

runs three ways:

* **K3** (``backend="auto"`` or ``"pallas"``): the df32 contraction of
  :mod:`akbx_torch.kernels.huygens`, a CUDA kernel on the card and its
  plain PyTorch twin on the CPU.  Differentiable through
  :class:`_PropagatePallasDD`, whose backward is the exact f64 path's.
* **f64** (``backend="xla"``, akbx's name for it): chunked over targets,
  each chunk under ``torch.utils.checkpoint`` so the backward recomputes
  instead of storing the N x M distance matrix; phases are range-reduced
  mod 2pi in double-word arithmetic (:func:`akbx_torch.core.trig.
  sincos_reduced`).
* **native** (``backend="native"``): akbx's C++/OpenMP engine in exact
  f64 on the host (:mod:`akbx_torch.native`), not differentiable.

Fields carry explicit f64 (re, im) pairs; each stage's geometry is
re-centred on its joint centroid before the distances.  Stage caching
lives in :mod:`akbx_torch.io`.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence

import torch
from torch.utils.checkpoint import checkpoint

from akbx_torch import device_of
from akbx_torch.core import precision as pr
from akbx_torch.core import trig as tg

F64 = torch.float64


class WaveField(NamedTuple):
    """A sampled complex field on a 3D point cloud: f64 tensors, with the
    quadrature weight ``ds`` carried alongside."""

    points: torch.Tensor  # (3, N) f64
    re: torch.Tensor  # (N,)
    im: torch.Tensor  # (N,)
    ds: torch.Tensor  # (N,) source-area quadrature weights
    n_h: int = 0
    n_v: int = 0

    @property
    def n(self) -> int:
        return self.points.shape[1]

    @property
    def u(self):
        """Complex view (complex128)."""
        return torch.complex(self.re, self.im)

    @staticmethod
    def from_complex(points, u, ds=None, n_h=0, n_v=0,
                     device=None) -> "WaveField":
        """From points (numpy or a tensor) and a complex field ``u``
        (numpy or a complex tensor), on ``device``, else on ``points``'
        device if it is a tensor, else on the card."""
        dev = device_of(points, device)
        points = torch.as_tensor(points, dtype=F64, device=dev)
        u = torch.as_tensor(u, device=dev)
        if u.is_complex():
            re, im = u.real, u.imag
        else:
            re, im = u, torch.zeros_like(u)
        if ds is None:
            ds = torch.ones(points.shape[1], dtype=F64, device=dev)
        return WaveField(points, re.to(F64), im.to(F64),
                         torch.as_tensor(ds, dtype=F64, device=dev), n_h, n_v)

    @property
    def intensity(self):
        return self.re**2 + self.im**2


def point_source(position=(0.0, 0.0, 0.0), device=None) -> WaveField:
    """Unit-amplitude single-point source, on ``device`` (default: the
    card, or ``position``'s device if it is a tensor)."""
    dev = device_of(position, device)
    p = torch.as_tensor(position, dtype=F64, device=dev).reshape(3, 1)
    one = torch.ones(1, dtype=F64, device=dev)
    return WaveField(p, one, torch.zeros(1, dtype=F64, device=dev), one, 1, 1)


def calc_ds(points: torch.Tensor, n_v: int, n_h: int) -> torch.Tensor:
    """Per-point surface area from the 4 neighbor triangles, edges copied
    inward — the Huygens quadrature weight (the reference's ``calc_dS``)."""
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
    # edge rows/cols copy the nearest interior value
    dS[0, :] = dS[1, :]
    dS[-1, :] = dS[-2, :]
    dS[:, 0] = dS[:, 1]
    dS[:, -1] = dS[:, -2]
    dS[0, 0] = dS[1, 1]
    dS[0, -1] = dS[1, -2]
    dS[-1, 0] = dS[-2, 1]
    dS[-1, -1] = dS[-2, -2]
    return dS.reshape(-1)


def _huygens_chunk(targets, src_points, src_re, src_im, k):
    """One (chunk, M) tile of the Huygens sum in f64 with reduced phases.

    ``src_re/src_im`` are pre-multiplied by ds.
    """
    dx = targets[0][:, None] - src_points[0][None, :]
    dy = targets[1][:, None] - src_points[1][None, :]
    dz = targets[2][:, None] - src_points[2][None, :]
    r = torch.sqrt(dx * dx + dy * dy + dz * dz)
    # phase = -k * r, range-reduced in double-word before sincos
    kp = pr.two_prod(torch.full_like(r, k), r)
    s, c = tg.sincos_reduced(-kp.hi, -kp.lo)
    inv_r = 1.0 / r
    cr = c * inv_r
    sr = s * inv_r
    # (a + ib)(c + is) with phase e^{-ikr} = c + i s  (s already has the sign)
    re = cr @ src_re - sr @ src_im
    im = sr @ src_re + cr @ src_im
    return re, im


def _propagate_xla(src_points, src_re, src_im, src_ds, target_points,
                   wavelength: float, chunk: int = 2048):
    """Differentiable f64 Huygens core: a loop over target chunks, each
    under ``torch.utils.checkpoint`` when a gradient is recorded.
    Gradients flow to fields, quadrature weights, and both geometries."""
    k = 2.0 * math.pi / wavelength
    center = torch.cat([src_points, target_points], dim=1).mean(
        dim=1, keepdim=True).detach()
    src_pts = src_points - center
    tgt_pts = target_points - center
    w_re = src_re * src_ds
    w_im = src_im * src_ds

    def body(t):
        return _huygens_chunk(t, src_pts, w_re, w_im, k)

    outs = []
    for a in range(0, tgt_pts.shape[1], chunk):
        t = tgt_pts[:, a:a + chunk]
        outs.append(checkpoint(body, t, use_reentrant=False)
                    if torch.is_grad_enabled() else body(t))
    if not outs:
        empty = tgt_pts.new_zeros(0)
        return empty, empty
    return (torch.cat([o[0] for o in outs]),
            torch.cat([o[1] for o in outs]))


class _PropagatePallasDD(torch.autograd.Function):
    """K3 forward (:func:`akbx_torch.kernels.huygens.propagate_pallas`)
    with an exact-f64 backward: the gradients of :func:`_propagate_xla`,
    recomputed on the saved inputs, numerically those of
    ``backend="xla"``."""

    @staticmethod
    def forward(ctx, src_points, src_re, src_im, src_ds, target_points,
                wavelength: float):
        from akbx_torch.kernels import huygens as hk

        ctx.save_for_backward(src_points, src_re, src_im, src_ds,
                              target_points)
        ctx.wavelength = wavelength
        src = WaveField(src_points, src_re, src_im, src_ds)
        return hk.propagate_pallas(src, target_points, wavelength)

    @staticmethod
    def backward(ctx, g_re, g_im):
        inputs = [x.detach().requires_grad_(need)
                  for x, need in zip(ctx.saved_tensors,
                                     ctx.needs_input_grad[:5])]
        wanted = [x for x in inputs if x.requires_grad]
        grads = iter(())
        if wanted:
            with torch.enable_grad():
                re, im = _propagate_xla(*inputs, ctx.wavelength)
                grads = iter(torch.autograd.grad((re, im), wanted,
                                                 (g_re, g_im),
                                                 allow_unused=True))
        return (*[next(grads) if x.requires_grad else None for x in inputs],
                None)


def _propagate_native(source: WaveField, target_points: torch.Tensor,
                      wavelength: float):
    """The native host engine on f64 copies of the inputs; the weights are
    ``re * ds`` and ``im * ds``, as akbx passes them."""
    from akbx_torch import native

    inputs = (source.points, source.re, source.im, source.ds, target_points)
    if any(isinstance(x, torch.Tensor) and x.requires_grad for x in inputs):
        raise RuntimeError("backend='native' is not differentiable: an input "
                           "requires grad (use 'xla' or 'pallas')")
    k = 2.0 * math.pi / wavelength
    re, im = native.huygens_propagate(target_points, source.points,
                                      source.re * source.ds,
                                      source.im * source.ds, k)
    dev = source.points.device
    return re.to(dev), im.to(dev)


def propagate(source: WaveField, target_points: torch.Tensor,
              wavelength: float, chunk: int = 2048,
              use_pallas: bool | None = None, backend: str = "auto"):
    """Huygens propagation: returns (re, im) f64 at ``target_points``.

    ``backend``: ``"auto"`` and ``"pallas"`` run K3 (the CUDA kernel on a
    CUDA tensor, its twin on a CPU tensor); ``"xla"`` runs the exact f64
    path in target chunks of ``chunk``; ``"native"`` runs akbx's C++/OpenMP
    host engine (:mod:`akbx_torch.native`) on copies of the inputs on the
    host, and returns on the source's device.  ``use_pallas`` is the legacy
    boolean form.  K3 and the f64 path are differentiable; the native
    engine raises on an input that requires grad.  A kernel or library that
    fails to build or launch raises; nothing falls back.
    """
    if backend == "native":
        return _propagate_native(source, target_points, float(wavelength))
    if backend not in ("auto", "pallas", "xla"):
        raise ValueError(f"unknown backend {backend!r}")
    if use_pallas is None:
        use_pallas = backend in ("auto", "pallas")
    if use_pallas:
        return _PropagatePallasDD.apply(source.points, source.re, source.im,
                                        source.ds, target_points,
                                        float(wavelength))
    return _propagate_xla(source.points, source.re, source.im, source.ds,
                          target_points, float(wavelength), chunk=chunk)


def propagate_field(source: WaveField, target_points, wavelength,
                    target_ds=None, n_h: int = 0, n_v: int = 0,
                    **kw) -> WaveField:
    """:func:`propagate` as a :class:`WaveField` on the targets (numpy
    targets and weights go to the source's device)."""
    dev = device_of(target_points, source.points.device)
    pts = torch.as_tensor(target_points, dtype=F64, device=dev)
    re, im = propagate(source, pts, wavelength, **kw)
    if target_ds is None:
        target_ds = torch.ones(re.shape[0], dtype=F64, device=dev)
    return WaveField(pts, re, im,
                     torch.as_tensor(target_ds, dtype=F64, device=dev),
                     n_h, n_v)


def propagate_stages(source: WaveField, stages: Sequence[dict],
                     wavelength: float, cache=None, **kw):
    """Sequential mirror-to-mirror pipeline: source -> M1 -> ... ->
    detector grids.

    ``stages``: list of dicts with keys ``points`` (3,N), optional ``ds``,
    ``name``, ``n_h``, ``n_v``.  ``cache``: optional
    :class:`akbx_torch.io.StageCache` for npz checkpoint/resume per stage.
    Returns the list of propagated fields.
    """
    fields = []
    current = source
    for i, stage in enumerate(stages):
        name = stage.get("name", f"M{i+1}")
        dev = device_of(stage["points"], current.points.device)
        pts = torch.as_tensor(stage["points"], dtype=F64, device=dev)
        ds = stage.get("ds")
        cached = cache.load(name, pts) if cache is not None else None
        if cached is not None:
            field = cached
        else:
            with torch.profiler.record_function(f"huygens:{name}"):
                field = propagate_field(current, pts, wavelength,
                                        target_ds=ds,
                                        n_h=stage.get("n_h", 0),
                                        n_v=stage.get("n_v", 0), **kw)
            if cache is not None:
                cache.save(name, field)
        fields.append(field)
        current = field
    return fields
