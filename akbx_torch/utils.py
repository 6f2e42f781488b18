"""Engine utilities (port of the part of :mod:`akbx.utils` that the wave
path calls): power-of-2 grid decimation and stage timers."""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch


def to_numpy(x) -> np.ndarray:
    """A tensor (on any device) or an array-like as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def downsample_grid(array, n_v: int, n_h: int, down_h: int = 0,
                    down_v: int = 0):
    """Power-of-2 grid decimation of (m, n_v*n_h) data (a tensor or a
    numpy array; the result has the input's type and device).

    ``down`` semantics follow the reference (0=keep, 2=half, 4=quarter,
    6=eighth — each step of 2 halves once).
    Returns (decimated (m, n_v'*n_h'), n_v', n_h').
    """
    a = array
    if a.ndim == 1:
        a = a[None, :]
    m = a.shape[0]
    g = a.reshape(m, n_v, n_h)
    for _ in range(down_h // 2):
        g = g[:, :, ::2]
    for _ in range(down_v // 2):
        g = g[:, ::2, :]
    out_v, out_h = g.shape[1], g.shape[2]
    return g.reshape(m, out_v * out_h), out_v, out_h


@contextlib.contextmanager
def stage_timer(name: str, log=print):
    """Wall-clock stage timing + a ``torch.profiler`` range of the same
    name (visible in a profiler trace).  The wall clock measures the host:
    on the card it ends before the stage's kernels do, unless the stage
    synchronises."""
    with torch.profiler.record_function(name):
        t0 = time.time()
        yield
        log(f"[{name}] {time.time() - t0:.3f} s")
