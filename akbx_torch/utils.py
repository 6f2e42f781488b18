"""Engine utilities (port of :mod:`akbx.utils`): ``jnp.linspace``'s
formula, thinned index lists, the edge-dense sigmoid fan, ray angles, grid
pitches, power-of-2 grid decimation, stage timers, a stdout tee, a
profiler trace and progress chunks."""

from __future__ import annotations

import contextlib
import os
import sys
import time

import numpy as np
import torch

from akbx_torch import spans


def to_numpy(x) -> np.ndarray:
    """A tensor (on any device) or an array-like as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


_CONSTANTS: dict = {}


def constant(values, like: torch.Tensor, dtype=None) -> torch.Tensor:
    """``values`` (a number or nested tuples of numbers) as a tensor of
    ``dtype`` (default ``like``'s) on ``like``'s device, made once per
    (values, dtype, device) and shared by every caller, which only reads
    it: after the first call no copy from host memory, so a caller may run
    inside a CUDA graph's capture.  Numbers equal in Python share one
    tensor (0.0 and -0.0 among them)."""
    dtype = dtype or like.dtype
    key = (values, dtype, like.device)
    t = _CONSTANTS.get(key)
    if t is None:
        with torch.inference_mode(False), torch.no_grad():
            t = torch.tensor(values, dtype=dtype, device=like.device)
        _CONSTANTS[key] = t
    return t


def linspace(lo, hi, n: int, like: torch.Tensor | None = None):
    """``jnp.linspace(lo, hi, n)`` in float64, bit for bit: ``lo (1 - s) +
    hi s`` with ``s = i / (n - 1)``, the last point exactly ``hi``.  The
    result is on the device of ``lo``, ``hi`` or ``like``, whichever is a
    tensor first (``torch.linspace`` rounds otherwise).  Differentiable in
    ``lo`` and ``hi``."""
    dev = next((t.device for t in (lo, hi, like)
                if isinstance(t, torch.Tensor)), torch.device("cpu"))
    lo = torch.as_tensor(lo, dtype=torch.float64, device=dev)
    hi = torch.as_tensor(hi, dtype=torch.float64, device=dev)
    if n == 1:
        return lo.reshape(1)
    s = torch.arange(n - 1, dtype=torch.float64, device=dev) / (n - 1)
    return torch.cat([lo * (1 - s) + hi * s, hi.reshape(1)])


def crop_indices(start: int, end: int, step: int):
    """Thinned index list (the reference's ``crop``)."""
    return list(range(end + 1))[start:end:step]


def sigmoid(x):
    return 1.0 / (1.0 + torch.exp(-x))


def non_uniform_distribution(start, end, num_points: int):
    """Edge-dense sampling of ``[start, end]`` through a sigmoid ramp (the
    reference's ``create_non_uniform_distribution``)."""
    s = sigmoid(linspace(-6.0, 6.0, num_points, like=start))
    scaled = (s - s.min()) / (s.max() - s.min())
    return start + (end - start) * scaled


def angle_between(ray1: torch.Tensor, ray2: torch.Tensor):
    """Angles between two (3, N) ray batches, and the per-ray y/x and z/x
    angles of ``ray1`` (NaN where its x component is 0).
    Returns (angle_between (N,), angle_yx (N,), angle_zx (N,))."""
    dot = torch.sum(ray1 * ray2, dim=0)
    cx = ray1[1] * ray2[2] - ray1[2] * ray2[1]
    cy = ray1[2] * ray2[0] - ray1[0] * ray2[2]
    cz = ray1[0] * ray2[1] - ray1[1] * ray2[0]
    cross = torch.sqrt(cx**2 + cy**2 + cz**2)
    between = torch.atan2(cross, dot)
    ok = ray1[0] != 0
    nan = torch.full_like(dot, float("nan"))
    yx = torch.where(ok, torch.atan2(ray1[1], ray1[0]), nan)
    zx = torch.where(ok, torch.atan2(ray1[2], ray1[0]), nan)
    return between, yx, zx


def data_pitch(points: torch.Tensor, n_v: int, n_h: int):
    """Mean grid pitches of a (3, N) surface grid in y and z (the
    reference's ``CalcDataPitch``, returning the values)."""
    y = points[1].reshape(n_v, n_h)
    z = points[2].reshape(n_v, n_h)
    return {
        "dy_rows": float(torch.mean(torch.diff(y, dim=0))),
        "dy_cols": float(torch.mean(torch.diff(y, dim=1))),
        "dz_rows": float(torch.mean(torch.diff(z, dim=0))),
        "dz_cols": float(torch.mean(torch.diff(z, dim=1))),
    }


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
    name (visible in a profiler trace): the span ``name`` where the spans
    are on (:mod:`akbx_torch.spans`), else the bare range.  The wall clock
    measures the host: on the card it ends before the stage's kernels do,
    unless the stage synchronises."""
    with spans.span_or_range(name):
        t0 = time.time()
        yield
        log(f"[{name}] {time.time() - t0:.3f} s")


class TeeOutput:
    """Write to a stream (stdout by default) and append to a log file
    (the reference's ``DualOutput``)."""

    def __init__(self, path: str, stream=None):
        self.file = open(path, "a")
        self.stream = stream or sys.stdout

    def write(self, data):
        self.stream.write(data)
        self.file.write(data)

    def flush(self):
        self.stream.flush()
        self.file.flush()

    def close(self):
        self.file.close()


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Profile the block with ``torch.profiler`` (the card's activity too,
    where there is a card) and write a Chrome trace into ``log_dir``
    (open it in Perfetto or chrome://tracing).  The spans
    (:mod:`akbx_torch.spans`) are on for the block, so the trace shows the
    port's layers.  Yields the profiler; after the block, ``prof.spans``
    holds the block's records where the block switched the spans on, and
    is None where they were on already (the records stay for the caller's
    :func:`akbx_torch.spans.take`)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    device = "cpu"
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
        device = "cuda"
    os.makedirs(log_dir, exist_ok=True)
    owner = not spans.enabled()
    if owner:
        spans.enable(device)
    try:
        with profile(activities=activities) as prof:
            yield prof
    finally:
        if owner:
            records = spans.take()
            spans.disable()
    prof.spans = records if owner else None
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def progress_chunks(total: int, fraction: float = 0.01):
    """Chunk boundaries for coarse progress reporting (the reference's
    1%-increment loop)."""
    step = max(int(total * fraction), 1)
    return [(i, min(i + step, total)) for i in range(0, total, step)]
