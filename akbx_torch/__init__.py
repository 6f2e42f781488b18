"""akbx_torch: the PyTorch / CUDA port of :mod:`akbx`.

Module names mirror ``akbx``'s (``akbx_torch.core.precision`` is the
counterpart of ``akbx.core.precision``, and so on).  Host math is float64
on every tensor constructor: optical path lengths are ~1e2 m with ~1e-10 m
signals.  The per-ray and per-pair hot loops run in hand-written CUDA
kernels (:mod:`akbx_torch.kernels`) on a CUDA tensor, and in their plain
PyTorch twins on a CPU tensor.

Entry points run on the card unless the caller asks for another device:
a constructor given ``device=None`` and no tensor to follow builds on
:func:`default_device`, and a tensor argument keeps its own device.

This package never imports ``jax``.
"""

import torch

__version__ = "0.2.0"


def default_device() -> torch.device:
    """The device of every constructor called without one: the card.
    Without a card, building a tensor there raises (torch's own error);
    nothing falls back to the CPU."""
    return torch.device("cuda")


def device_of(x=None, device=None) -> torch.device:
    """``device`` if given, else the device of a tensor ``x``, else
    :func:`default_device` (``torch.as_tensor``'s rule, with the card as
    the default)."""
    if device is not None:
        return torch.device(device)
    if isinstance(x, torch.Tensor):
        return x.device
    return default_device()
