"""sin/cos of huge optical phases (port of
:func:`akbx.core.trig.sincos_reduced`).

The rest of :mod:`akbx.core.trig` works around f32-grade f64 scalar
transcendentals on the TPU; in PyTorch those are plain ``torch`` calls.
"""

from __future__ import annotations

import torch

from akbx_torch.core import precision as pr

TWO_PI_HI = 6.283185307179586
TWO_PI_LO = 2.4492935982947064e-16  # 2*pi = HI + LO to ~1e-32


def sincos_reduced(phase_hi, phase_lo=None):
    """sin/cos of a (possibly huge) phase, range-reduced mod 2pi.

    ``phase_hi (+ phase_lo)`` is a double-word phase in radians; the
    reduction ``phase - 2pi * round(phase / 2pi)`` is done in double-word
    arithmetic so phases up to ~1e16 rad keep ~1e-10 rad residual accuracy.
    Returns (sin, cos).
    """
    if phase_lo is None:
        phase_lo = torch.zeros_like(phase_hi)
    n = torch.round(phase_hi / TWO_PI_HI)
    # phase - n*2pi in double-word
    t1 = pr.two_prod(n, torch.full_like(n, TWO_PI_HI))
    red = pr.df_add(pr.DF(phase_hi, phase_lo), pr.DF(-t1.hi, -t1.lo))
    red = pr.df_add_f(red, -n * TWO_PI_LO)
    r = red.hi + red.lo
    return torch.sin(r), torch.cos(r)
