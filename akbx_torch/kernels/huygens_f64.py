"""The exact-f64 Huygens tile K4, the per-rank sum of
:func:`akbx_torch.parallel.sharding.huygens_ring`.

For every target i it adds into ``acc_re[i]``, ``acc_im[i]``

    sum_j (w_re_j + i w_im_j) exp(-i k r_ij) / r_ij

in f64 throughout, with the phase ``k r`` an exact double-word product,
reduced mod 2pi in double-word (:func:`akbx_torch.core.trig.
sincos_reduced`).  Three parts: the plain PyTorch twin
:func:`huygens_f64_reference` (:func:`huygens_tile` over chunks of
:data:`CHUNK` targets), the CUDA C++ kernel
``akbx_torch/csrc/huygens_f64_kernel.cu``, and the dispatching wrapper
:func:`huygens_f64`, which runs the twin on CPU tensors and launches the
kernel on CUDA tensors, never falling back.  It counts the kernel's
launches in ``huygens_f64.launches``.  :func:`huygens_tile` is also the
differentiable f64 path of ``wave`` (``backend="xla"``, K3's backward).

Kernel and twin do the same operations per pair in the same order, so
``r``, the reduced phase and ``1/r`` agree bit for bit (the kernel's
``two_prod`` is the FMA form, the twin's Dekker's: the same exact pair).
They differ in sin and cos by at most an ulp and in the order of the sums:
the twin contracts each chunk with four matrix-vector products; the kernel
sums each split of :data:`SPLIT` sources one by one, in source order, and
adds the splits' sums in split order, with no atomics, so its runs repeat
bit for bit.
"""

from __future__ import annotations

import torch

from akbx_torch.core import precision as pr
from akbx_torch.core import trig as tg
from akbx_torch.core import use_kernel
from akbx_torch.kernels import F64, check, raise_on, stream

SPLIT = 512            # sources per partial sum (the kernel's K4_SPLIT)
SCRATCH_BYTES = 1 << 26  # the most scratch a launch takes; more targets
                         # than fit are launched in chunks
CHUNK = 1024           # targets per tile of the twin


def huygens_tile(targets, src_points, src_re, src_im, k):
    """One (chunk, M) tile of the Huygens sum in f64 with reduced phases.

    ``src_re/src_im`` are pre-multiplied by ds.  Differentiable.
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


def huygens_f64_reference(tgt, src_pts, src_re_w, src_im_w, k: float,
                          acc_re, acc_im):
    """Plain PyTorch twin of K4: :func:`huygens_tile` over chunks of
    :data:`CHUNK` targets, each chunk's sums added into ``acc_re``,
    ``acc_im`` in place."""
    for a in range(0, tgt.shape[1], CHUNK):
        re, im = huygens_tile(tgt[:, a:a + CHUNK], src_pts, src_re_w,
                              src_im_w, k)
        acc_re[a:a + CHUNK] += re
        acc_im[a:a + CHUNK] += im


def huygens_f64(tgt, src_pts, src_re_w, src_im_w, k: float, acc_re, acc_im):
    """K4: adds the Huygens sum of the sources into the targets' f64
    accumulators, in place.

    ``tgt`` (3, N) and ``src_pts`` (3, M) f64 positions; ``src_re_w``,
    ``src_im_w`` (M,) f64 weights, ds included; ``k`` the wavenumber;
    ``acc_re``, ``acc_im`` (N,) f64.  Every tensor contiguous and on one
    device.  The twin on CPU tensors (differentiable), the CUDA kernel on
    CUDA tensors, which records no gradient: there an input that requires
    grad under grad mode raises.
    """
    n, m = tgt.shape[-1], src_pts.shape[-1]
    check(tgt, F64, (3, n), "tgt")
    check(src_pts, F64, (3, m), "src_pts")
    check(src_re_w, F64, (m,), "src_re_w")
    check(src_im_w, F64, (m,), "src_im_w")
    check(acc_re, F64, (n,), "acc_re")
    check(acc_im, F64, (n,), "acc_im")
    ins = (tgt, src_pts, src_re_w, src_im_w, acc_re, acc_im)
    if not use_kernel(*ins):
        huygens_f64_reference(tgt, src_pts, src_re_w, src_im_w, k, acc_re,
                              acc_im)
        return
    if torch.is_grad_enabled() and any(t.requires_grad for t in ins):
        raise ValueError("huygens_f64: K4 records no gradient; an input "
                         "requires grad")
    from akbx_torch.kernels import _build

    if not (n and m):
        return
    lib = _build.load()
    splits = -(-m // SPLIT)
    per = max(1, SCRATCH_BYTES // (2 * splits * 8))
    part = torch.empty((2 * splits, min(n, per)), dtype=F64,
                       device=tgt.device)
    for a in range(0, n, per):
        b = min(n, a + per)
        rc = lib.akbx_huygens_f64(
            tgt.data_ptr() + 8 * a, n, b - a, src_pts.data_ptr(),
            src_re_w.data_ptr(), src_im_w.data_ptr(), m, float(k),
            part.data_ptr(), acc_re.data_ptr() + 8 * a,
            acc_im.data_ptr() + 8 * a, stream(tgt))
        raise_on(rc, "huygens_f64")
        huygens_f64.launches += 1


huygens_f64.launches = 0
