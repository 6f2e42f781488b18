"""akbx_torch: the PyTorch / CUDA port of :mod:`akbx`.

Module names mirror ``akbx``'s (``akbx_torch.core.precision`` is the
counterpart of ``akbx.core.precision``, and so on).  Host math is float64
on every tensor constructor: optical path lengths are ~1e2 m with ~1e-10 m
signals.  The per-ray hot loops run in hand-written CUDA kernels
(:mod:`akbx_torch.kernels`) on a CUDA tensor, and in their plain PyTorch
twins on a CPU tensor.

This package never imports ``jax``.
"""

__version__ = "0.1.0"
