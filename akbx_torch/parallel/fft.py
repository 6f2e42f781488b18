"""Sharded 2D FFT for large-pupil PSFs (port of :mod:`akbx.parallel.fft`;
BASELINE config 4).

The classic distributed decomposition, on ``torch.distributed``: each rank
holds N/P full rows of the (N, M) array and

1. FFTs its rows along the last axis;
2. transposes to column sharding with one ``all_to_all_single`` (the
   local (N/P, M) block is cut into P contiguous (N/P, M/P) tiles, tile
   ``j`` goes to rank ``j``, and the received tiles stack into (N, M/P));
3. FFTs its columns along the first axis;
4. transposes back to row sharding with a second ``all_to_all_single``.

NCCL has no complex type, so the tiles travel as ``view_as_real``.  A
``torch.autograd.Function`` carries the backward through the same sharded
schedule.  torch's gradient of a complex linear map ``A`` is ``A^H g``
(the conjugate Wirtinger convention; JAX's VJP is ``A^T g``).  The DFT
matrix is symmetric, so ``A^H g = conj(A conj(g))``: the transform itself
between two conjugations.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from akbx_torch.parallel import sharding as sh

F64 = torch.float64


def _check_divisible(n: int, m: int, p: int):
    if n % p or m % p:
        raise ValueError(
            f"sharded fft2 needs both sides divisible by the mesh size: "
            f"got {n}x{m} over {p} devices")


def shard_rows(mesh, u: torch.Tensor) -> torch.Tensor:
    """This rank's N/P rows of the 2D array ``u``."""
    p = mesh.size()
    _check_divisible(u.shape[0], 0, p)
    c = u.shape[0] // p
    r = mesh.get_local_rank()
    return u[r * c:(r + 1) * c]


def gather_rows(u: torch.Tensor, mesh) -> torch.Tensor:
    """The global array of row-sharded ``u``, on every rank
    (differentiable)."""
    parts = sh._quiet(sh.dfn.all_gather, torch.view_as_real(u).contiguous(),
                      group=sh._group(mesh))
    return torch.cat([torch.view_as_complex(q) for q in parts], dim=0)


def _all_to_all(tiles: torch.Tensor, mesh) -> torch.Tensor:
    """(P, a, b) complex tiles, tile ``j`` to rank ``j``; returns the
    (P, a, b) tiles received, tile ``q`` from rank ``q``."""
    send = torch.view_as_real(tiles.contiguous())
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=sh._group(mesh))
    return torch.view_as_complex(recv)


def _fft2_raw(u: torch.Tensor, mesh, inverse: bool) -> torch.Tensor:
    """The sharded transform of this rank's (N/P, M) rows."""
    fft1 = torch.fft.ifft if inverse else torch.fft.fft
    p = mesh.size()
    a, m = u.shape
    u = fft1(u, dim=1)
    # row-sharded -> column-sharded: (N, M/P)
    u = _all_to_all(u.reshape(a, p, m // p).permute(1, 0, 2), mesh)
    u = fft1(u.reshape(p * a, m // p), dim=0)
    # back to row sharding: tile q holds rank q's rows of my columns
    u = _all_to_all(u.reshape(p, a, m // p), mesh)
    return u.permute(1, 0, 2).reshape(a, m)


class _ShardedFFT2(torch.autograd.Function):
    @staticmethod
    def forward(ctx, u, mesh, inverse):
        ctx.mesh, ctx.inverse = mesh, inverse
        return _fft2_raw(u, mesh, inverse)

    @staticmethod
    def backward(ctx, g):
        return (torch.conj(_fft2_raw(torch.conj(g), ctx.mesh, ctx.inverse)),
                None, None)


def make_fft2(mesh, inverse: bool = False):
    """A differentiable sharded ``fft2`` (or ``ifft2``) over ``mesh``: it
    maps this rank's rows (:func:`shard_rows`) of an (N, M) array to its
    rows of the 2D DFT.  Both sides must be divisible by the mesh size; a
    real input becomes complex first."""
    p = mesh.size()

    def fft2(u: torch.Tensor) -> torch.Tensor:
        _check_divisible(u.shape[0] * p, u.shape[1], p)
        if not u.is_complex():
            u = u.to(torch.complex128 if u.dtype == F64
                     else torch.complex64)
        return _ShardedFFT2.apply(u, mesh, inverse)

    return fft2


def psf_fft_sharded(opd_m, amp, wavelength_m, pupil_dx_m, focal_length_m,
                    mesh, pad_factor: int = 2, window: str | None = None,
                    return_efield: bool = False, pupil_dy_m=None):
    """:func:`akbx_torch.analysis.psf.compute_psf_fft` with the transform
    sharded over ``mesh``: the same numerics and signature (plus
    ``mesh``), for pupils too large for one card.  The pre- and
    post-processing (mask, window, pad, fftshift, normalize) run
    replicated on every rank, on the mesh's device; only the fft2 is
    sharded, and its rows are gathered after it.  Returns the same
    replicated outputs as the unsharded call.

    Pupils whose (even-padded) side is not divisible by the mesh size are
    zero-amplitude-padded up to the next multiple first: the field is
    unchanged, only the image-plane sampling is finer than the unsharded
    call's."""
    from akbx_torch.analysis import psf as _psf

    p = mesh.size()
    dev = sh.mesh_device(mesh)
    opd_m = torch.atleast_2d(torch.as_tensor(opd_m, dtype=F64, device=dev))
    amp = torch.atleast_2d(torch.as_tensor(amp, dtype=F64, device=dev))
    ny, nx = amp.shape
    # compute_psf_fft's even-size pad, then up to a multiple of the mesh
    tgt_y = -((ny + ny % 2) // -p) * p
    tgt_x = -((nx + nx % 2) // -p) * p
    if (tgt_y, tgt_x) != (ny, nx):
        pad = (0, tgt_x - nx, 0, tgt_y - ny)
        opd_m = torch.nn.functional.pad(opd_m, pad)
        amp = torch.nn.functional.pad(amp, pad)  # zero amplitude

    fft2 = make_fft2(mesh)

    def fft2_shifted(U):
        rows = shard_rows(mesh, torch.fft.ifftshift(U))
        return torch.fft.fftshift(gather_rows(fft2(rows), mesh))

    return _psf.compute_psf_fft(
        opd_m, amp, wavelength_m, pupil_dx_m, focal_length_m,
        pad_factor=pad_factor, window=window, return_efield=return_efield,
        pupil_dy_m=pupil_dy_m, fft2_shifted_fn=fft2_shifted)
