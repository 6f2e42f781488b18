"""``csrc/df32.cuh``'s ``two_prod`` on arrays, for tests: the card's FMA
form against the PyTorch twin :func:`akbx_torch.core.precision.two_prod`.
No path of the port calls it."""

from __future__ import annotations

import torch

from akbx_torch.core import precision, use_kernel
from akbx_torch.kernels import F32, check, ptr, raise_on, stream


def two_prod(a: torch.Tensor, b: torch.Tensor) -> precision.DF:
    """``(p, e)`` with ``p + e = a b`` exactly, for (n,) float32 tensors:
    the twin on CPU tensors, the header's ``two_prod`` on CUDA tensors."""
    if not use_kernel(a, b):
        return precision.two_prod(a, b)
    from akbx_torch.kernels import _build

    n = a.shape[0]
    check(a, F32, (n,), "a")
    check(b, F32, (n,), "b")
    hi, lo = torch.empty_like(a), torch.empty_like(a)
    raise_on(_build.load().akbx_two_prod(ptr(a), ptr(b), n, ptr(hi), ptr(lo),
                                         stream(a)), "two_prod")
    return precision.DF(hi, lo)
